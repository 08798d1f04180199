"""MLA (deepseek-v3) and Mamba-1 (the jamba hybrid) in the PyTorch port
against the JAX package's `models/attention.py` and `models/ssm.py`, on the
CPU, on the JAX package's own weights (`params_from_jax`):
`mla_forward` (with the latent it returns for the cache), `mla_decode` in
both modes (naive: the whole latent cache up-projected; absorbed:
`cfg.mla_absorb`, kv_up folded into the query and output projections) with
and without a sliding window, `mamba_forward` from a fresh and from a
carried state, and `mamba_decode`; each in bf16 (the draws as they are)
and on f32 copies of them.  deepseek-v3-671b-smoke's first layer (MLA:
4 heads, q_lora 64, kv_lora 32, nope 32 + rope 16, v 32) and
jamba-v0.1-52b-smoke's first layer (Mamba: d 256, d_inner 512, N 16,
conv 4, dt_rank 16).

Tolerances, of the scale (max |diff| / max |want|), with the largest gap
measured on an x86-64 CPU, one thread:
  * bf16: 2e-2, as tests/test_torch_llm_modules.py (bf16 matmuls that
    torch and XLA may accumulate in different orders; Mamba's SiLU rounded
    once by F.silu, op by op by XLA): MLA 0 (forward, absorbed decode) and
    3.8e-5 (naive decode), Mamba 6.2e-3 (fresh), 6.7e-3 (carried), 7.5e-3
    (decode);
  * f32: 1e-5 (what is left is summation order): MLA up to 3.8e-7, Mamba
    up to 8.2e-7.
Cache and state leaves are held to the same; ring positions and write
indices exactly, and the ring slots decode does not write bitwise.
The Mamba scan's backward writes bytes linear in T (its steps sliced by
unbind: the backward of T index slices writes T zero-filled copies of the
whole sequence's decay and input, T^2 bytes).
"""
from _torch_oracle import jax_llm_params, rel_max  # noqa: I001  (alias first)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.configs import get_config as jax_get_config
from repro.models import attention as JA
from repro.models import ssm as JS
from repro_torch.configs import get_config
from repro_torch.models import attention as TA
from repro_torch.models import ssm as TS
from repro_torch.models.transformer import params_from_jax
from repro_torch.train.tree import tree_leaves as param_leaves
from repro_torch.train.tree import tree_unflatten

TOL = {"bf16": 2e-2, "f32": 1e-5}
MLA, MAMBA = "deepseek-v3-671b-smoke", "jamba-v0.1-52b-smoke"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(arch, **kw):
    return (dataclasses.replace(jax_get_config(arch), **kw),
            dataclasses.replace(get_config(arch), **kw))


def _mixer(jcfg, tcfg, name, dtype):
    """The first layer's mixer parameters: (JAX tree, port tree), bf16 as
    drawn or f32 copies."""
    jp = jax_llm_params(jcfg, seed=3)
    if dtype == "f32":
        jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    return (jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), jp["s0_l0"][name]),
            params_from_jax(tcfg, jp)["s0_l0"][0][name])


def _x(shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "f32":
        return jnp.asarray(x), torch.from_numpy(x)
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("window", [0, 8])
def test_mla_forward_matches_jax(dtype, window):
    """Prefill MLA (causal; with a window, also the window mask) and the
    latent (c_kv, rotated k_pe) it hands the cache."""
    jcfg, tcfg = _configs(MLA, sliding_window=window)
    jp, tp = _mixer(jcfg, tcfg, "attn", dtype)
    xj, xt = _x((2, 24, jcfg.d_model), 1, dtype)
    want, (cj, kj) = JA.mla_forward(jp, jcfg, xj, return_kv=True)
    got, (ct, kt) = TA.mla_forward(tp, tcfg, xt, return_kv=True)
    assert got.dtype == xt.dtype and tuple(got.shape) == want.shape
    assert tuple(ct.shape) == cj.shape and tuple(kt.shape) == kj.shape
    for g, w in ((got, want), (ct, cj), (kt, kj)):
        assert rel_max(g, w) < TOL[dtype]


def _latent_cache(jcfg, dtype, b, c, s):
    """A ring of C slots holding s tokens' latents (positions 0..s-1): the
    JAX cache and the port's."""
    cj, ct = _x((b, c, jcfg.kv_lora_rank), 2, dtype)
    kj, kt = _x((b, c, jcfg.qk_rope_dim), 3, dtype)
    pos = np.where(np.arange(c) < s, np.arange(c), -1).astype(np.int32)
    jcache = {"c_kv": cj, "k_pe": kj, "pos": jnp.asarray(pos), "idx": jnp.asarray(s, jnp.int32)}
    tcache = {"c_kv": ct, "k_pe": kt, "pos": torch.from_numpy(pos.copy()),
              "idx": torch.tensor(s, dtype=torch.int32)}
    return jcache, tcache


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("absorb", [False, True], ids=["naive", "absorbed"])
def test_mla_decode_matches_jax(absorb, window, dtype):
    """One decode step over a part-filled latent ring, each mode against
    the JAX package's same mode: output, the latent written at idx % C in
    place (the other slots untouched), positions and idx."""
    jcfg, tcfg = _configs(MLA, sliding_window=window, mla_absorb=absorb)
    jp, tp = _mixer(jcfg, tcfg, "attn", dtype)
    b, c, s = 2, 20, 13
    jcache, tcache = _latent_cache(jcfg, dtype, b, c, s)
    before = {k: v.clone() for k, v in tcache.items()}
    xj, xt = _x((b, 1, jcfg.d_model), 4, dtype)
    want, jnew = JA.mla_decode(jp, jcfg, xj, jcache, jnp.asarray(s, jnp.int32))
    got, tnew = TA.mla_decode(tp, tcfg, xt, tcache, torch.tensor(s, dtype=torch.int32))
    assert tnew is tcache                                     # updated in place
    assert got.dtype == xt.dtype and rel_max(got, want) < TOL[dtype]
    assert np.array_equal(tnew["pos"].numpy(), np.asarray(jnew["pos"]))
    assert int(tnew["idx"]) == int(jnew["idx"]) == s + 1
    untouched = np.arange(c) != s
    for name in ("c_kv", "k_pe"):
        assert rel_max(tnew[name], jnew[name]) < TOL[dtype]
        assert torch.equal(tnew[name][:, untouched], before[name][:, untouched])


# --------------------------------------------------------------------------
# Mamba
# --------------------------------------------------------------------------

def _mamba_state(jcfg, dtype, b, seed):
    """A carried state: random SSM state (f32) and conv window."""
    h = np.random.default_rng(seed).standard_normal(
        (b, jcfg.mamba_d_inner, jcfg.mamba_d_state)).astype(np.float32)
    cj, ct = _x((b, jcfg.mamba_d_conv - 1, jcfg.mamba_d_inner), seed + 1, dtype)
    return ({"ssm": jnp.asarray(h), "conv": cj},
            {"ssm": torch.from_numpy(h.copy()), "conv": ct})


def _check_state(tst, jst, dtype):
    assert set(tst) == set(jst) == {"ssm", "conv"}
    for name in ("ssm", "conv"):
        assert tuple(tst[name].shape) == jst[name].shape
        assert str(tst[name].dtype).split(".")[-1] == jst[name].dtype.name
        assert rel_max(tst[name], jst[name]) < TOL[dtype], name


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("state", ["fresh", "carried"])
def test_mamba_forward_matches_jax(state, dtype):
    """The full-sequence selective scan (T 16) from zeros and from a
    carried state: output and the new state (SSM state and conv window)."""
    jcfg, tcfg = _configs(MAMBA)
    jp, tp = _mixer(jcfg, tcfg, "mamba", dtype)
    b = 2
    xj, xt = _x((b, 16, jcfg.d_model), 5, dtype)
    if state == "fresh":
        want, jst = JS.mamba_forward(jp, jcfg, xj)
        got, tst = TS.mamba_forward(tp, tcfg, xt)
    else:
        js, ts = _mamba_state(jcfg, dtype, b, 6)
        keep = {k: v.clone() for k, v in ts.items()}
        want, jst = JS.mamba_forward(jp, jcfg, xj, js)
        got, tst = TS.mamba_forward(tp, tcfg, xt, ts)
        assert all(torch.equal(ts[k], keep[k]) for k in ts)   # the input state as it was
    assert got.dtype == xt.dtype and tuple(got.shape) == want.shape
    assert rel_max(got, want) < TOL[dtype]
    _check_state(tst, jst, dtype)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_mamba_decode_matches_jax(dtype):
    """Three decode steps (T = 1) chained from a carried state, each
    against JAX's: output and state."""
    jcfg, tcfg = _configs(MAMBA)
    jp, tp = _mixer(jcfg, tcfg, "mamba", dtype)
    js, ts = _mamba_state(jcfg, dtype, 2, 7)
    for step in range(3):
        xj, xt = _x((2, 1, jcfg.d_model), 8 + step, dtype)
        want, js = JS.mamba_decode(jp, jcfg, xj, js)
        got, ts = TS.mamba_decode(tp, tcfg, xt, ts)
        assert rel_max(got, want) < TOL[dtype], step
        _check_state(ts, js, dtype)


class _BytesWritten(TorchDispatchMode):
    """The bytes of every op's outputs while the mode is on, but views'
    (which write nothing)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.total += sum(t.nbytes for t in tree_leaves(out) if isinstance(t, torch.Tensor))
        return out


def _backward_bytes(tcfg, tp, t):
    x = torch.randn(2, t, tcfg.d_model, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    leaves = [v.detach().requires_grad_(True) for v in param_leaves(tp)]
    out, _ = TS.mamba_forward(tree_unflatten(tp, leaves), tcfg, x)
    written = _BytesWritten()
    with written:
        torch.autograd.grad(out.float().square().sum(), [x, *leaves])
    return written.total


def test_mamba_backward_writes_bytes_linear_in_the_sequence():
    """Four times the tokens, about four times the bytes the backward
    writes: under 5x (3.7x measured; the scan sliced by index wrote 13.9x,
    and 16x as T grows)."""
    jcfg, tcfg = _configs(MAMBA)
    _, tp = _mixer(jcfg, tcfg, "mamba", "f32")
    short, long = _backward_bytes(tcfg, tp, 16), _backward_bytes(tcfg, tp, 64)
    assert long < 5 * short, (short, long)


def test_mamba_init_matches_the_jax_constants():
    """`mamba_init` draws the JAX package's shapes and dtypes, with its
    constants: D = 1, the dt bias log(expm1(0.01)) and a zero conv bias
    exactly, A = 1..N per channel as its log within one f32 ulp (torch's
    log is correctly rounded; XLA's CPU log(7) is 1 ulp above it);
    dt_rank = d // 16."""
    jcfg, tcfg = _configs(MAMBA)
    want = jax.tree_util.tree_map(np.asarray, JS.mamba_init(jax.random.PRNGKey(0), jcfg))
    got = TS.mamba_init(torch.Generator().manual_seed(0), tcfg)
    assert set(got) == set(want)
    assert got["dt_proj"]["w"].shape[0] == jcfg.d_model // 16
    for name in want:
        w, g = want[name], got[name]
        if isinstance(w, dict):
            w, g = w["w"], g["w"]
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == w.dtype.name, name
        if name in ("d_skip", "dt_bias", "conv_b"):
            assert np.array_equal(g.float().numpy(), w.astype(np.float32)), name
    np.testing.assert_allclose(got["a_log"].numpy(), want["a_log"], rtol=2**-23, atol=0)
