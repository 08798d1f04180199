"""The model zoo's mixers in the PyTorch port against the JAX package, on
the CPU, on the JAX package's own weights (`params_from_jax`): GQA prefill
and ring-cache decode (qwen2-7b-smoke), RWKV-6 time-mix and channel-mix
(rwkv6-7b-smoke); and the config registry and parameter mapping.

Tolerance: module outputs are bf16 from bf16 matmuls that torch and XLA
accumulate in different orders, so each is held to 2e-2 of its scale
(max |diff| / max |want|), half the JAX package's end-to-end serving
tolerance of 4e-2.
"""
from _torch_oracle import jax_llm_params, rel_max  # noqa: I001  (alias first)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.models import attention as JA
from repro.models import ssm as JS
from repro.models.transformer import param_count as jax_param_count
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import wkv6
from repro_torch.models import attention as TA
from repro_torch.models import ssm as TS
from repro_torch.models.transformer import (init_params, param_count, params_from_jax,
                                            stage_plan)

TOL = 2e-2


def _configs(arch, **kw):
    return (dataclasses.replace(jax_get_config(arch), **kw),
            dataclasses.replace(get_config(arch), **kw))


def _layer0(jcfg, tcfg):
    jp = jax_llm_params(jcfg, seed=3)
    return (jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), jp["s0_l0"]),
            params_from_jax(tcfg, jp)["s0_l0"][0])


def _x(shape, seed, dtype=jnp.bfloat16):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_gqa_forward_matches_jax(impl):
    jcfg, tcfg = _configs("qwen2-7b-smoke", attn_impl=impl)
    jp, tp = _layer0(jcfg, tcfg)
    xj, xt = _x((2, 32, jcfg.d_model), 1)
    want, (kj, vj) = JA.gqa_forward(jp["attn"], jcfg, xj, return_kv=True)
    got, (kt, vt) = TA.gqa_forward(tp["attn"], tcfg, xt, return_kv=True)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    for g, w in ((got, want), (kt, kj), (vt, vj)):
        assert rel_max(g, w) < TOL


@pytest.mark.parametrize("window", [0, 8])
def test_gqa_decode_matches_jax(window):
    """One decode step over a part-filled ring (and, with a window, the
    window mask): output, ring write at idx % C, positions and idx."""
    jcfg, tcfg = _configs("qwen2-7b-smoke", sliding_window=window)
    jp, tp = _layer0(jcfg, tcfg)
    b, c, s = 2, 20, 13
    kj, kt = _x((b, c, jcfg.n_kv_heads, jcfg.head_dim), 2)
    vj, vt = _x((b, c, jcfg.n_kv_heads, jcfg.head_dim), 3)
    pos = np.where(np.arange(c) < s, np.arange(c), -1).astype(np.int32)
    jcache = {"k": kj, "v": vj, "pos": jnp.asarray(pos), "idx": jnp.asarray(s, jnp.int32)}
    tcache = {"k": kt, "v": vt, "pos": torch.from_numpy(pos.copy()),
              "idx": torch.tensor(s, dtype=torch.int32)}
    xj, xt = _x((b, 1, jcfg.d_model), 4)
    want, jnew = JA.gqa_decode(jp["attn"], jcfg, xj, jcache, jnp.asarray(s, jnp.int32))
    got, tnew = TA.gqa_decode(tp["attn"], tcfg, xt, tcache, torch.tensor(s, dtype=torch.int32))
    assert tnew is tcache                                     # updated in place
    assert rel_max(got, want) < TOL
    assert np.array_equal(tnew["pos"].numpy(), np.asarray(jnew["pos"]))
    assert int(tnew["idx"]) == int(jnew["idx"]) == s + 1
    for name in ("k", "v"):
        assert rel_max(tnew[name], jnew[name]) < TOL
        untouched = np.arange(c) != s
        assert torch.equal(tnew[name][:, untouched], {"k": kt, "v": vt}[name][:, untouched])


@pytest.mark.parametrize("t", [1, 16])
def test_rwkv6_time_mix_matches_jax(t):
    """Prefill-length and decode (T = 1) time-mix from a random non-zero
    state, with a random non-zero bonus u; the port through the K5 wrapper
    (its plain version on the CPU), JAX through `wkv6_scan_ref`."""
    jcfg, tcfg = _configs("rwkv6-7b-smoke", rwkv_wkv_impl="pallas")
    jp, tp = _layer0(jcfg, tcfg)
    u = np.random.default_rng(5).standard_normal(np.asarray(jp["rwkv"]["u"]).shape)
    jp["rwkv"]["u"] = jnp.asarray(u, jnp.float32)
    tp["rwkv"]["u"] = torch.from_numpy(u.astype(np.float32))
    b, h, hs = 2, jcfg.n_rwkv_heads, jcfg.rwkv_head_size
    s0 = np.random.default_rng(6).standard_normal((b, h, hs, hs)).astype(np.float32)
    pj, pt = _x((b, jcfg.d_model), 7)
    xj, xt = _x((b, t, jcfg.d_model), 8)
    want, jst = JS.rwkv6_time_mix(jp["rwkv"], jcfg, xj, {"wkv": jnp.asarray(s0), "prev_tok": pj})
    got, tst = TS.rwkv6_time_mix(tp["rwkv"], tcfg, xt,
                                 {"wkv": torch.from_numpy(s0), "prev_tok": pt}, wkv_impl=wkv6)
    assert got.dtype == torch.bfloat16
    assert rel_max(got, want) < TOL
    assert rel_max(tst["wkv"], jst["wkv"]) < TOL
    assert torch.equal(tst["prev_tok"], xt[:, -1])


@pytest.mark.parametrize("t", [1, 16])
def test_rwkv6_channel_mix_matches_jax(t):
    jcfg, tcfg = _configs("rwkv6-7b-smoke")
    jp, tp = _layer0(jcfg, tcfg)
    pj, pt = _x((2, jcfg.d_model), 9)
    xj, xt = _x((2, t, jcfg.d_model), 10)
    want, jprev = JS.rwkv6_channel_mix(jp["rwkv"], jcfg, xj, pj)
    got, tprev = TS.rwkv6_channel_mix(tp["rwkv"], tcfg, xt, pt)
    assert rel_max(got, want) < TOL
    assert torch.equal(tprev, xt[:, -1])


@pytest.mark.parametrize("arch", ["qwen2-7b-smoke", "rwkv6-7b-smoke",
                                  "granite-moe-3b-a800m-smoke", "qwen1.5-110b-smoke"])
def test_params_from_jax_and_init_params_match_the_jax_tree(arch):
    """`params_from_jax` unstacks each group's leading `repeats` axis
    without changing a value; `init_params` draws a tree of the same
    structure, shapes and dtypes, with the JAX package's constants."""
    jcfg, tcfg = _configs(arch)
    jp = jax_llm_params(jcfg, seed=1)
    tp = params_from_jax(tcfg, jp)
    mine = init_params(tcfg, torch.Generator().manual_seed(0))
    assert param_count(tp) == param_count(mine) == jax_param_count(jp)
    reps = stage_plan(tcfg)[0].repeats
    assert len(tp["s0_l0"]) == len(mine["s0_l0"]) == reps == jcfg.n_layers
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        keys = [p.key for p in path]
        for i in range(reps if keys[0] == "s0_l0" else 1):
            node_t, node_m = tp, mine
            for j, key in enumerate(keys):
                node_t, node_m = node_t[key], node_m[key]
                if j == 0 and key == "s0_l0":
                    node_t, node_m = node_t[i], node_m[i]
            want = np.asarray(leaf)[i] if keys[0] == "s0_l0" else np.asarray(leaf)
            assert tuple(node_t.shape) == tuple(node_m.shape) == want.shape, keys
            assert str(node_t.dtype).split(".")[-1] == str(node_m.dtype).split(".")[-1] \
                == want.dtype.name, keys
            assert np.array_equal(node_t.float().numpy(), want.astype(np.float32)), keys
            if keys[-1] in ("g", "mu", "mu_c", "w0", "u", "b"):       # constants
                assert np.array_equal(node_m.float().numpy(), want.astype(np.float32)), keys


def test_config_registry():
    """The JAX package's ten archs, each equal to its JAX config and smoke
    variant."""
    assert sorted(ARCHS) == ["deepseek-v3-671b", "granite-moe-3b-a800m", "jamba-v0.1-52b",
                             "qwen1.5-110b", "qwen2-7b", "qwen2-vl-2b", "rwkv6-7b",
                             "stablelm-3b", "whisper-base", "yi-6b"]
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for name in ARCHS:
        assert get_config(name) == ARCHS[name]
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jax_get_config(name))
        assert dataclasses.asdict(get_config(name + "-smoke")) == \
            dataclasses.asdict(jax_get_config(name + "-smoke"))
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("gpt-5")
