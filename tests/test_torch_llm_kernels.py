"""The model zoo's building blocks in the PyTorch port against the JAX
package, on the CPU: the token pipeline, the layers, and the plain versions
of kernels K4 (flash attention) and K5 (the WKV6 recurrence).

The JAX K4 runs as its Pallas kernel in interpret mode.  The JAX K5 kernel
does not run under the installed jax (its `pl.store` is gone), so K5's
plain version is held to the kernel's own oracle, `wkv6_scan_ref`.

The CUDA kernels' numerics are held here too, by torch emulations of their
arithmetic: the bf16 tensor-core K4's split of P into bf16 p_hi + p_lo
against the card's gate, and K5's tree sum spread over threads against
the plain version's tree, to the bit.
"""
from _torch_oracle import bf16_ulp, f32, rel_max  # noqa: I001  (alias first)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import synthetic_token_batch as jax_token_batch
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import layers as JL
from repro.models.ssm import wkv6_scan_ref
from repro_torch.data.pipeline import synthetic_token_batch
from repro_torch.kernels import flash_attention, flash_attention_plain, wkv6, wkv6_plain
from repro_torch.kernels.rwkv6_wkv.ref import _tree_sum
from repro_torch.models import layers as TL

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(shape, seed, dtype_name, scale=1.0):
    """The same values as a JAX array and a torch tensor (rounded to the
    dtype once, in JAX, and the bits handed over)."""
    jd, td = DTYPES[dtype_name]
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape) * scale, jd)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(td)


@pytest.mark.parametrize("seed,batch,seq,vocab", [(0, 4, 64, 1024), (7, 2, 513, 152064),
                                                  (3, 1, 1, 65536)])
def test_synthetic_token_batch_is_bit_identical(seed, batch, seq, vocab):
    want = jax_token_batch(np.random.default_rng(seed), batch, seq, vocab)
    got = synthetic_token_batch(np.random.default_rng(seed), batch, seq, vocab)
    for key in ("tokens", "labels"):
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key])


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

# f32: the same f32 arithmetic up to summation order (1e-6 relative);
# bf16: both compute in f32 and round once, so at most one bf16 ulp apart.
def _close(got, want, dtype_name):
    got, want = f32(got), f32(want)
    if dtype_name == "f32":
        assert rel_max(got, want) < 1e-6
    else:
        assert np.all(np.abs(got - want) <= bf16_ulp(np.maximum(np.abs(got), np.abs(want))))


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_rmsnorm_matches_jax(dtype_name):
    xj, xt = _pair((2, 5, 256), 1, dtype_name, scale=3.0)
    g = np.random.default_rng(2).uniform(0.5, 1.5, 256).astype(np.float32)
    want = JL.rmsnorm({"g": jnp.asarray(g)}, xj, 1e-5)
    got = TL.rmsnorm({"g": torch.from_numpy(g)}, xt, 1e-5)
    assert got.dtype == DTYPES[dtype_name][1]
    _close(got, want, dtype_name)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_swiglu_matches_jax(dtype_name):
    """bf16 matmuls accumulate in another order in torch and XLA, so the
    bf16 case is held to 2e-2 of the output's scale (f32: 1e-5)."""
    xj, xt = _pair((2, 4, 64), 3, dtype_name)
    ws = {n: _pair(s, 10 + i, dtype_name, scale=0.1)
          for i, (n, s) in enumerate((("gate", (64, 96)), ("up", (64, 96)), ("down", (96, 64))))}
    want = JL.swiglu({n: {"w": w[0]} for n, w in ws.items()}, xj)
    got = TL.swiglu({n: {"w": w[1]} for n, w in ws.items()}, xt)
    assert rel_max(got, want) < (1e-5 if dtype_name == "f32" else 2e-2)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_apply_rope_matches_jax(dtype_name):
    """Angles up to 600 rad: an ulp of the inverse frequency moves an angle
    by ~6e-5, so f32 is held to 1e-4 of the scale; bf16 to one ulp plus
    that."""
    xj, xt = _pair((2, 7, 3, 64), 4, dtype_name)
    pos = np.array([[0, 1, 2, 5, 63, 200, 600]], np.int32)
    want = JL.apply_rope(xj, jnp.asarray(pos), 1e6)
    got = TL.apply_rope(xt, torch.from_numpy(pos), 1e6)
    assert got.dtype == DTYPES[dtype_name][1]
    diff = np.abs(f32(got) - f32(want))
    if dtype_name == "f32":
        assert diff.max() < 1e-4
    else:
        assert np.all(diff <= bf16_ulp(np.maximum(np.abs(f32(got)), np.abs(f32(want)))) + 1e-4)
    np.testing.assert_allclose(TL.rope_freqs(64, 1e6).numpy(),
                               np.asarray(JL.rope_freqs(64, 1e6)), rtol=1e-6)


# --------------------------------------------------------------------------
# K4: flash attention
# --------------------------------------------------------------------------

def _qkv(b, sq, sk, hq, hkv, d, dtype_name, seed):
    qj, qt = _pair((b, sq, hq, d), seed, dtype_name)
    kj, kt = _pair((b, sk, hkv, d), seed + 1, dtype_name)
    vj, vt = _pair((b, sk, hkv, d), seed + 2, dtype_name)
    return (qj, kj, vj), (qt, kt, vt)


@pytest.mark.parametrize("d", [32, 80])
@pytest.mark.parametrize("g", [1, 2, 7])
@pytest.mark.parametrize("sq,sk", [(64, 64), (32, 64)])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_flash_plain_matches_pallas_interpret(dtype_name, window, sq, sk, g, d):
    """The plain version against the JAX K4 (Pallas, interpret mode), causal,
    right-aligned queries, GQA by head h -> h // G, at head dims 32 and 80
    (stablelm-3b's; scale 80**-0.5).  Both accumulate in f32 and cast once:
    f32 within 1e-5; bf16 within one ulp, plus the f32 tolerance for outputs
    near 0 (there the two f32 results, ~1e-6 apart, can round to bf16
    values two ulps apart)."""
    hkv = 2
    (qj, kj, vj), (qt, kt, vt) = _qkv(2, sq, sk, hkv * g, hkv, d, dtype_name, 5 * g + sq)
    want = jax_flash(qj, kj, vj, causal=True, window=window, bq=32, bk=32, interpret=True)
    got = flash_attention_plain(qt, kt, vt, causal=True, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    if dtype_name == "f32":
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)
    else:
        diff = np.abs(f32(got) - f32(want))
        assert np.all(diff <= bf16_ulp(np.maximum(np.abs(f32(got)), np.abs(f32(want)))) + 1e-5)


@pytest.mark.parametrize("window,sq", [(0, 64), (16, 64), (0, 24), (9, 24)])
def test_flash_plain_matches_attention_ref_f32(window, sq):
    """In f32 the probabilities' cast in `attention_ref` is a no-op, so the
    two differ only in where the normalisation happens: 1e-5."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(2, sq, 64, 3, 3, 32, "f32", 40 + window)
    to_bhsd = lambda x: jnp.transpose(x, (0, 2, 1, 3))      # noqa: E731
    want = attention_ref(to_bhsd(qj), to_bhsd(kj), to_bhsd(vj), causal=True, window=window)
    got = flash_attention_plain(qt, kt, vt, causal=True, window=window)
    np.testing.assert_allclose(f32(got), f32(to_bhsd(want)), rtol=1e-5, atol=1e-5)


def test_flash_wrapper_runs_the_plain_version_on_the_cpu():
    (_, _, _), (qt, kt, vt) = _qkv(1, 16, 16, 4, 2, 64, "bf16", 9)
    before = flash_attention.launches
    assert torch.equal(flash_attention(qt, kt, vt, causal=True, window=4),
                       flash_attention_plain(qt, kt, vt, causal=True, window=4))
    assert flash_attention.launches == before          # no kernel launched on the CPU


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    """bf16(x) as the kernel rounds it, by integer work: 0x8000 added to the
    bits of f32 x, the low 16 cleared (to nearest, ties away from zero)."""
    return ((x.view(torch.int32) + 0x8000) & -65536).view(torch.float32)


def _flash_split_p(q, k, v, *, window, tile=64, split=True):
    """The bf16 tensor-core K4's arithmetic (csrc/flash_attention.cu,
    flash_fwd_bf16_wgmma) in torch: f32 scores in the log2 domain, the
    online softmax over tiles of 64 keys, and each tile's probabilities
    split into bf16 p_hi + p_lo (p_hi = bf16(p), p_lo = bf16(p - p_hi)),
    both multiplied by V and accumulated in f32; one cast at the end.
    split=False drops p_lo (P rounded to bf16 once, to nearest)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale_log2 = torch.tensor(d**-0.5, dtype=torch.float32) * torch.tensor(1.4426950408889634,
                                                                            dtype=torch.float32)
    qg = q.float().reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale_log2
    rows = torch.arange(sq)[:, None] + (sk - sq)
    cols = torch.arange(sk)[None, :]
    mask = cols <= rows
    if window > 0:
        mask &= cols > rows - window
    s = torch.where(mask, s, -1e30)
    m = torch.full(s.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:-1] + (d,))
    for k0 in range(0, sk, tile):
        x, vt = s[..., k0:k0 + tile], v.float()[:, k0:k0 + tile]
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        if split:
            hi = _bf16_round(p)
            lo = _bf16_round(p - hi)
        else:
            hi, lo = p.bfloat16().float(), torch.zeros_like(p)
        pv = (torch.einsum("bhgqk,bkhd->bhgqd", hi, vt)
              + torch.einsum("bhgqk,bkhd->bhgqd", lo, vt))
        acc = acc * alpha + pv
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
    o = acc / l.clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


@pytest.mark.parametrize("g", [1, 7])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("sq,sk", [(256, 256), (100, 230)])
@pytest.mark.parametrize("d", [64, 80, 128])
def test_flash_split_p_stays_within_the_card_gate(d, sq, sk, window, g):
    """The bf16 K4 kernel's P.V with P split into bf16 p_hi + p_lo stays
    within the card's gate (chip_smoke.py, tests/test_torch_cuda.py) of the
    plain version: one bf16 ulp plus 1e-5 on every output.  P rounded to
    bf16 alone breaks it."""
    (_, _, _), (qt, kt, vt) = _qkv(1, sq, sk, 2 * g, 2, d, "bf16", d + sq + window + g)
    want = flash_attention_plain(qt, kt, vt, causal=True, window=window)

    def within_gate(got):
        diff = np.abs(f32(got) - f32(want))
        return diff <= bf16_ulp(np.maximum(np.abs(f32(got)), np.abs(f32(want)))) + 1e-5

    assert np.all(within_gate(_flash_split_p(qt, kt, vt, window=window)))
    assert not np.all(within_gate(_flash_split_p(qt, kt, vt, window=window, split=False)))


# --------------------------------------------------------------------------
# K5: the WKV6 recurrence
# --------------------------------------------------------------------------

def _wkv_inputs(b, t, h, hs, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, hs)).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-7, 0, (b, t, h, hs)))).astype(np.float32)
    u = rng.standard_normal((h, hs)).astype(np.float32)
    s0 = rng.standard_normal((b, h, hs, hs)).astype(np.float32)
    return r, k, v, w, u, s0


def _split_tree_sum(x: torch.Tensor, tpc: int) -> torch.Tensor:
    """The K5 kernel's sum over the last dim with `tpc` threads per column
    (csrc/rwkv6_wkv.cu): thread c owns the entries i = c, c + tpc, ...,
    sums them by its own pairwise tree, and the last log2(tpc) levels add
    thread c + off's partial sum into thread c's for off = tpc/2, ..., 1."""
    lanes = [_tree_sum(x[..., c::tpc], dim=-1) for c in range(tpc)]
    off = tpc // 2
    while off:
        lanes = [lanes[c] + lanes[c + off] for c in range(off)]
        off //= 2
    return lanes[0]


@pytest.mark.parametrize("tpc", [2, 4, 8])
@pytest.mark.parametrize("hs", [32, 64])
def test_wkv6_split_tree_is_the_plain_tree(hs, tpc):
    """The tree spread over tpc threads is the plain version's `_tree_sum`,
    to the bit, on sums whose terms span six decades (where any other
    order, such as a left fold, rounds differently)."""
    rng = np.random.default_rng(hs * tpc)
    x = torch.from_numpy((rng.standard_normal((4096, hs))
                          * 10.0 ** rng.uniform(-3, 3, (4096, hs))).astype(np.float32))
    want = _tree_sum(x, dim=-1)
    assert torch.equal(_split_tree_sum(x, tpc), want)
    fold = x[:, 0]
    for i in range(1, hs):
        fold = fold + x[:, i]
    assert not torch.equal(fold, want)               # the data can tell orders apart


def _wkv6_split(r, k, v, w, u, state, tpc):
    """`wkv6_plain` with the sum over i taken as the K5 kernel takes it with
    `tpc` threads per column."""
    s, ys = state, []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = k_t[..., :, None] * v_t[..., None, :]
        a = s + u[None, :, :, None] * kv
        ys.append(_split_tree_sum((r_t[..., :, None] * a).transpose(-1, -2), tpc))
        s = w_t[..., None] * s + kv
    return torch.stack(ys, dim=1), s


@pytest.mark.parametrize("tpc", [4, 8])
@pytest.mark.parametrize("t", [1, 7, 37])
def test_wkv6_split_matches_plain_bitwise(t, tpc):
    """The K5 kernel's arithmetic with 4 or 8 threads per column gives the
    plain version's y and final state to the bit (hs 64, random non-zero u
    and initial state)."""
    args = [torch.from_numpy(a) for a in _wkv_inputs(2, t, 3, 64, 100 + t)]
    y, s = _wkv6_split(*args, tpc)
    y_p, s_p = wkv6_plain(*args)
    assert torch.equal(y, y_p) and torch.equal(s, s_p)


@pytest.mark.parametrize("t", [1, 7, 128])
def test_wkv6_plain_matches_scan_ref(t):
    """f32 recurrence, random non-zero u and initial state: y and the final
    state within 1e-5 of their scale (summation order differs)."""
    args = _wkv_inputs(2, t, 3, 32, t)
    y_j, s_j = wkv6_scan_ref(*map(jnp.asarray, args))
    y_t, s_t = wkv6_plain(*map(torch.from_numpy, args))
    assert y_t.shape == (2, t, 3, 32) and s_t.shape == (2, 3, 32, 32)
    assert rel_max(y_t, y_j) < 1e-5
    assert rel_max(s_t, s_j) < 1e-5
    before = wkv6.launches
    y_w, s_w = wkv6(*map(torch.from_numpy, args))                # CPU: the plain version
    assert torch.equal(y_w, y_t) and torch.equal(s_w, s_t) and wkv6.launches == before


def test_wkv6_scan_ref_is_the_plain_version():
    from repro_torch.models.ssm import wkv6_scan_ref as port_scan_ref
    assert port_scan_ref is wkv6_plain
