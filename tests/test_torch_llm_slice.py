"""The model zoo's serving slice in the PyTorch port against the JAX
package, on the CPU, on the JAX package's own weights (`params_from_jax`):
prefill logits and the prefill cache, teacher-forced decode, and the
port's prefill + decode against its own full forward — for the attention
archs' smoke configs (qwen2-7b, stablelm-3b, yi-6b, qwen1.5-110b and the
MoE granite-moe-3b-a800m; attn_impl="pallas" on both sides: the JAX K4 in
interpret mode, the port's K4 plain version), stablelm-3b-smoke widened to
K4's head dim 80 (d_model 320, 4 heads; the smoke config's is 64), and
rwkv6-7b-smoke (rwkv_wkv_impl="pallas" in the port, "ref" in JAX, whose K5
kernel no longer runs under the installed jax).

Tolerance: 4e-2 of the scale (max |diff| / max |want|), the JAX package's
own serving tolerance (tests/test_serving.py).
"""
from _torch_oracle import jax_llm_params, rel_max  # noqa: I001  (alias first)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import transformer as TT

TOL = 4e-2
PALLAS = ({"attn_impl": "pallas"}, {"attn_impl": "pallas"})
D80 = {"d_model": 320, "n_heads": 4, "n_kv_heads": 2, "d_head": 80}
# case -> (arch, JAX overrides, port overrides)
CASES = {"qwen2-7b-smoke": ("qwen2-7b-smoke",) + PALLAS,
         "rwkv6-7b-smoke": ("rwkv6-7b-smoke", {}, {"rwkv_wkv_impl": "pallas"}),
         "stablelm-3b-smoke": ("stablelm-3b-smoke",) + PALLAS,
         "yi-6b-smoke": ("yi-6b-smoke",) + PALLAS,
         "qwen1.5-110b-smoke": ("qwen1.5-110b-smoke",) + PALLAS,
         "granite-moe-3b-a800m-smoke": ("granite-moe-3b-a800m-smoke",) + PALLAS,
         "stablelm-3b-smoke-d80": ("stablelm-3b-smoke", dict(PALLAS[0], **D80),
                                   dict(PALLAS[1], **D80))}
NEW = ["stablelm-3b-smoke", "yi-6b-smoke", "qwen1.5-110b-smoke", "granite-moe-3b-a800m-smoke"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: beside other test
    workers, torch's default (one thread per core each) oversubscribes the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(case, seed=11):
    arch, jkw, tkw = CASES[case]
    jcfg = dataclasses.replace(jax_get_config(arch), **jkw)
    tcfg = dataclasses.replace(get_config(arch), **tkw)
    jp_np = jax_llm_params(jcfg, seed)
    jp = jax.tree_util.tree_map(jnp.asarray, jp_np)
    return jcfg, tcfg, jp, TT.params_from_jax(tcfg, jp_np)


def _tokens(vocab, b, n, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, n)).astype(np.int32)


def _leaves(cache):
    return jax.tree_util.tree_flatten_with_path(cache)[0]


def _port_leaf(cache, path):
    for p in path:
        cache = cache[p.key]
    return cache


@pytest.mark.parametrize("arch", sorted(CASES))
def test_prefill_logits_and_cache_match_jax(arch):
    jcfg, tcfg, jp, tp = _setup(arch)
    b, s, nd = 2, 32, 3
    toks = _tokens(jcfg.vocab, b, s)
    jl, _, jcache = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)}, mode="prefill",
                               cache_headroom=nd)
    tl, _, tcache = TT.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)}, mode="prefill",
                               cache_headroom=nd)
    assert tl.dtype == torch.bfloat16 and tuple(tl.shape) == jl.shape
    assert rel_max(tl, jl) < TOL
    leaves = _leaves(jcache)
    assert len(leaves) == len(jax.tree_util.tree_leaves(tcache))
    for path, want in leaves:
        got = _port_leaf(tcache, path)
        assert tuple(got.shape) == want.shape, path
        if want.dtype == jnp.int32:                     # ring positions, write index
            assert np.array_equal(got.numpy(), np.asarray(want)), path
        else:
            assert rel_max(got, want) < TOL, path


@pytest.mark.parametrize("arch", sorted(CASES))
def test_teacher_forced_decode_matches_jax(arch):
    """Both decode the same tokens (JAX's greedy choices) from their own
    prefill caches: logits of every step within 4e-2, caches too."""
    jcfg, tcfg, jp, tp = _setup(arch)
    b, s, nd = 2, 24, 4
    toks = _tokens(jcfg.vocab, b, s, seed=1)
    jl, _, jcache = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)}, mode="prefill",
                               cache_headroom=nd)
    _, _, tcache = TT.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)}, mode="prefill",
                              cache_headroom=nd)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    for d in range(nd):
        jg, jcache = JT.decode_step(jcfg, jp, {"token": jnp.asarray(tok),
                                               "pos": jnp.asarray(s + d, jnp.int32)}, jcache)
        tg, tcache = TT.decode_step(tcfg, tp, {"token": torch.from_numpy(tok),
                                               "pos": torch.tensor(s + d, dtype=torch.int32)},
                                    tcache)
        assert rel_max(tg, jg) < TOL, d
        tok = np.asarray(jnp.argmax(jg[:, -1], -1)).astype(np.int32)[:, None]
    for path, want in _leaves(jcache):
        got = _port_leaf(tcache, path)
        if want.dtype == jnp.int32:
            assert np.array_equal(got.numpy(), np.asarray(want)), path
        else:
            assert rel_max(got, want) < TOL, path


@pytest.mark.parametrize("arch,window", [("qwen2-7b-smoke", 0), ("rwkv6-7b-smoke", 0),
                                         ("qwen2-7b-smoke", 16)]
                         + [(a, 0) for a in NEW] + [("granite-moe-3b-a800m-smoke", 16)])
def test_prefill_decode_matches_full(arch, window):
    """The port's prefill + ring-buffer decode equals its own full forward
    (the port's mirror of tests/test_serving.py); with a 16-token window,
    decoding past the window overwrites the ring."""
    _, tcfg, _, tp = _setup(arch)
    tcfg = dataclasses.replace(tcfg, sliding_window=window)
    b, s, nd = 2, 24 if window else 32, 8 if window else 3
    toks = torch.from_numpy(_tokens(tcfg.vocab, b, s + nd, seed=2))
    _, _, cache = TT.forward(tcfg, tp, {"tokens": toks[:, :s]}, mode="prefill",
                             cache_headroom=nd)
    if window:
        assert cache["s0_l0"]["k"].shape[2] == window     # physical cache capped at the window
    ref = TT.forward(tcfg, tp, {"tokens": toks}, mode="train")[0]
    for d in range(nd):
        got, cache = TT.decode_step(tcfg, tp, {"token": toks[:, s + d:s + d + 1],
                                               "pos": torch.tensor(s + d)}, cache)
        assert rel_max(got[:, 0], ref[:, s + d]) < TOL, d


@pytest.mark.parametrize("arch", sorted(CASES))
def test_init_cache_cold_decode(arch):
    """Decoding from an empty cache (`init_cache`) gives finite logits and
    advances every layer's write index by one."""
    _, tcfg, _, tp = _setup(arch)
    cache = TT.init_cache(tcfg, 2, 16, "cpu")
    logits, cache = TT.decode_step(tcfg, tp, {"token": torch.zeros(2, 1, dtype=torch.int32),
                                              "pos": torch.tensor(0)}, cache)
    assert logits.shape == (2, 1, tcfg.vocab) and bool(torch.isfinite(logits.float()).all())
    if "idx" in cache["s0_l0"]:
        assert cache["s0_l0"]["idx"].tolist() == [1] * tcfg.n_layers
