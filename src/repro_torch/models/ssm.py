"""RWKV-6 ("Finch", data-dependent decay), the attention-free mixer of the
rwkv6 family, and Mamba-1, the selective SSM of the jamba hybrid (PyTorch
copy of the JAX package's `models/ssm.py`).

A full-sequence form and, with T = 1, the decode form with its
constant-size recurrent state.  The WKV recurrence itself is passed in
(`wkv_impl`): the transformer hands it the K5 wrapper for
`rwkv_wkv_impl="pallas"` (the CUDA kernel on the card, its plain version
for CPU tensors) and `wkv6_scan_ref` (the plain loop) for `"ref"`.

Simplification kept from the JAX package: token-shift mixing coefficients
are static per channel; the data-dependent *decay* w_t is kept, via the
low-rank `w_lora` path.

Mamba's selective scan is a `jax.lax.scan` in the JAX package, not a
kernel; here it is a plain loop over T (two elementwise ops and one
product a step), with the decay exp(dt * A) and the input dt * B * x
computed for the whole sequence first, as the JAX package does.

On a mesh whose `model` axis has more than one rank (`tp`, a
`models.tensor_parallel.TP`) both mixers run on this rank's part only, as
the rules lay the weights out.  RWKV-6 is head-parallel: wr, wk, wv, wg,
w_lora_b and the channel-mix's ck and cr are column blocks of whole heads,
wo and cv row blocks; w0, u and ln_x (replicated) are sliced to this
rank's heads, and the WKV recurrence (K5 with "pallas") runs on its heads,
whose state the cache holds as this rank's block.  The channel-mix's cv
sum is reduce-scattered onto cr's columns and the product all-gathered
once.  Mamba is channel-parallel: in_proj holds this rank's channels of
xi and of z side by side (`sharding.params.PAIRED`), dt_proj, conv_w,
conv_b, a_log, dt_bias and d_skip its d_inner block, out_proj a row
block; the replicated x_proj reads the rank's channels and its partial
(B, T, dt_rank + 2N) is summed over `model` (B and C, read by every
rank's channels, sum their gradients back).  The ssm and conv states are
the rank's channel blocks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.rwkv6_wkv.ref import wkv6_plain as wkv6_scan_ref
from ..sharding import comm
from . import tensor_parallel as TPM
from .layers import DTYPE, dense, dense_init, normal_bf16

__all__ = [
    "rwkv6_init",
    "rwkv6_time_mix",
    "rwkv6_channel_mix",
    "init_rwkv6_state",
    "wkv6_scan_ref",
    "mamba_init",
    "mamba_forward",
    "mamba_decode",
    "init_mamba_state",
]


def rwkv6_init(gen: torch.Generator, cfg: ArchConfig):
    d = cfg.d_model
    dev = gen.device
    lora = 64
    return {
        # time-mix (attention-replacement) --------------------------------
        "mu": torch.full((5, d), 0.5, dtype=torch.float32, device=dev),  # r,k,v,g,w shifts
        "wr": dense_init(gen, d, d),
        "wk": dense_init(gen, d, d),
        "wv": dense_init(gen, d, d),
        "wg": dense_init(gen, d, d),
        "wo": dense_init(gen, d, d),
        "w0": torch.full((d,), -6.0, dtype=torch.float32, device=dev),   # decay bias
        "w_lora_a": dense_init(gen, d, lora, scale=0.01),
        "w_lora_b": dense_init(gen, lora, d, scale=0.01),
        "u": torch.zeros(cfg.n_rwkv_heads, cfg.rwkv_head_size, dtype=torch.float32,
                         device=dev),                                    # per-head bonus
        "ln_x": {"g": torch.ones(d, dtype=torch.float32, device=dev)},
        # channel-mix (FFN-replacement) ------------------------------------
        "mu_c": torch.full((2, d), 0.5, dtype=torch.float32, device=dev),
        "ck": dense_init(gen, d, cfg.d_ff),
        "cv": dense_init(gen, cfg.d_ff, d),
        "cr": dense_init(gen, d, d),
    }


def _shift(x, prev):
    """Token shift: x_{t-1} along the sequence; prev fills t=0."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in float32, as the recurrences compute, or in float64 where it is (a
    float64 run keeps its precision)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _rwkv6_tp(tp, p, cfg: ArchConfig):
    """`tp` for an RWKV-6 layer after checking its blocks (whole heads per
    rank; refused where the heads do not divide `model`)."""
    if tp is None:
        return None
    d, h = cfg.d_model, cfg.n_rwkv_heads
    if h % tp.size:
        leaf = ".".join(str(k) for k in tp.where + ("wr",))
        raise ValueError(f"{leaf}: RWKV-6's {h} heads do not divide model={tp.size}; its "
                         "tensor-parallel form takes whole heads per rank")
    for name in ("wr", "wk", "wv", "wg", "w_lora_b", "cr"):
        TPM.block(tp, p[name]["w"], 1, d, name)
    TPM.block(tp, p["ck"]["w"], 1, cfg.d_ff, "ck")
    TPM.block(tp, p["wo"]["w"], 0, d, "wo")
    TPM.block(tp, p["cv"]["w"], 0, cfg.d_ff, "cv")
    return tp


def _rwkv6_mix(p, cfg: ArchConfig, x, prev_tok, tp=None):
    """Shared pre-recurrence projections. Returns r,k,v,w (B,T,H,hs) f32,
    g (B,T,d) (on a mesh this rank's heads and channels)."""
    b, t, _ = x.shape
    hs = cfg.rwkv_head_size
    xx = _shift(x, prev_tok)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (x + (xx - x) * mu[i] for i in range(5))
    r = _wide(TPM.col(tp, p["wr"], xr).reshape(b, t, -1, hs))
    k = _wide(TPM.col(tp, p["wk"], xk).reshape(b, t, -1, hs))
    v = _wide(TPM.col(tp, p["wv"], xv).reshape(b, t, -1, hs))
    g = F.silu(TPM.col(tp, p["wg"], xg))
    # Data-dependent decay (Finch): w_t = exp(-exp(w0 + lora(xw))).
    lora = TPM.col(tp, p["w_lora_b"], torch.tanh(dense(p["w_lora_a"], xw)))
    w_log = TPM.local(tp, p["w0"]) + _wide(lora)
    w = torch.exp(-torch.exp(w_log)).reshape(b, t, -1, hs)
    return r, k, v, w, g


def _rwkv6_out(p, cfg: ArchConfig, y, g, b, t, tp=None):
    # Per-head group normalization, folded to RMS over each head's channels.
    yh = _wide(y.reshape(b, t, -1, cfg.rwkv_head_size))
    yh = yh * torch.rsqrt(yh.square().mean(-1, keepdim=True) + 1e-5)
    yf = (yh.reshape(b, t, g.shape[-1]) * TPM.local(tp, p["ln_x"]["g"])).to(g.dtype)
    return TPM.row(tp, p["wo"], yf * g)


def rwkv6_time_mix(p, cfg: ArchConfig, x, state, *, wkv_impl=wkv6_scan_ref, tp=None):
    """Time-mix (attention replacement) over a full sequence. x: (B, T, d).

    state: {"wkv": (B,H,hs,hs) f32, "prev_tok": (B,d)}.  Works for T == 1
    (decode) and any prefill length; returns (out, new state) and leaves
    `state` as it was.  With `tp` head-parallel (module docstring): the
    state's "wkv" is this rank's (B, H / model, hs, hs) heads."""
    b, t, _ = x.shape
    tp = _rwkv6_tp(tp, p, cfg)
    r, k, v, w, g = _rwkv6_mix(p, cfg, x, state["prev_tok"], tp)
    y, s_new = wkv_impl(r, k, v, w, TPM.local(tp, p["u"]), state["wkv"])
    out = _rwkv6_out(p, cfg, y, g, b, t, tp)
    return out, {"wkv": s_new, "prev_tok": x[:, -1, :]}


def rwkv6_channel_mix(p, cfg: ArchConfig, x, prev_tok, tp=None):
    """Channel-mix (FFN replacement). Returns (y, new prev_tok (B, d)).
    With `tp`: ck and cr column blocks, cv a row block whose float32 sum
    over `model` is reduce-scattered onto cr's columns; the product is
    all-gathered."""
    xx = _shift(x, prev_tok)
    mu_c = p["mu_c"].to(x.dtype)
    xk = x + (xx - x) * mu_c[0]
    xr = x + (xx - x) * mu_c[1]
    tp = _rwkv6_tp(tp, p, cfg)
    r = TPM.col(tp, p["cr"], xr)
    kk = torch.square(torch.relu(TPM.col(tp, p["ck"], xk)))
    y = torch.sigmoid(r) * TPM.row_scatter(tp, p["cv"], kk)
    return TPM.gather_cols(tp, y), x[:, -1, :]


def init_rwkv6_state(cfg: ArchConfig, batch: int, device, heads: int | None = None):
    """Zero states; `heads` (default every head) WKV heads, e.g. a rank's."""
    h, hs = heads or cfg.n_rwkv_heads, cfg.rwkv_head_size
    return {
        "wkv": torch.zeros(batch, h, hs, hs, dtype=torch.float32, device=device),
        "prev_tok": torch.zeros(batch, cfg.d_model, dtype=DTYPE, device=device),
    }


# ==========================================================================
# Mamba-1 (selective SSM)
# ==========================================================================

def mamba_init(gen: torch.Generator, cfg: ArchConfig):
    d, di, n, dev = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state, gen.device
    dt_rank = max(d // 16, 1)
    a = torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(di, n)
    return {
        "in_proj": dense_init(gen, d, 2 * di),
        "conv_w": normal_bf16(gen, (cfg.mamba_d_conv, di), 0.2),
        "conv_b": torch.zeros(di, dtype=DTYPE, device=dev),
        "x_proj": dense_init(gen, di, dt_rank + 2 * n),
        "dt_proj": dense_init(gen, dt_rank, di, scale=dt_rank**-0.5),
        "dt_bias": torch.log(torch.expm1(torch.full((di,), 0.01, dtype=torch.float32,
                                                    device=dev))),
        "a_log": torch.log(a),
        "d_skip": torch.ones(di, dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, di, d),
    }


def _mamba_tp(tp, p, cfg: ArchConfig):
    """`tp` for a Mamba layer after checking its channel blocks."""
    if tp is None:
        return None
    di = cfg.mamba_d_inner
    for name, t, dim, whole in (("in_proj", p["in_proj"]["w"], 1, 2 * di),
                                ("dt_proj", p["dt_proj"]["w"], 1, di),
                                ("conv_w", p["conv_w"], 1, di), ("conv_b", p["conv_b"], 0, di),
                                ("a_log", p["a_log"], 0, di), ("dt_bias", p["dt_bias"], 0, di),
                                ("d_skip", p["d_skip"], 0, di),
                                ("out_proj", p["out_proj"]["w"], 0, di)):
        TPM.block(tp, t, dim, whole, name)
    return tp


def _mamba_ssm_inputs(p, cfg: ArchConfig, xc, tp=None):
    """xc: conv + silu output (B, T, di).  Returns dt (B, T, di) f32 and
    b, c (B, T, N) f32 (on a mesh xc and dt this rank's channels, b and c
    whole)."""
    n = cfg.mamba_d_state
    dt_rank = p["dt_proj"]["w"].shape[0]
    x_proj = dict(p["x_proj"], w=TPM.local(tp, p["x_proj"]["w"]))
    dt_low, bc = torch.split(TPM.row(tp, x_proj, xc), [dt_rank, 2 * n], dim=-1)
    if tp is not None:      # read by this rank's channels: their gradients summed
        bc = comm.copy_to_f32(bc, tp.group)
    b_ssm, c_ssm = bc.split([n, n], dim=-1)
    dt = F.softplus(_wide(TPM.col(tp, p["dt_proj"], dt_low)) + p["dt_bias"])
    return dt, _wide(b_ssm), _wide(c_ssm)


def mamba_forward(p, cfg: ArchConfig, x, state=None, tp=None):
    """x: (B, T, d); state {"ssm": (B, di, N) f32, "conv": (B, kw - 1, di)},
    zeros when None.  Full-sequence selective scan; returns (out, new state)
    and leaves `state` as it was.  T = 1 is the decode step.  With `tp`
    channel-parallel (module docstring): di is this rank's d_inner / model
    channels, in the state too."""
    b, t, _ = x.shape
    kw = cfg.mamba_d_conv
    tp = _mamba_tp(tp, p, cfg)
    if state is None:
        state = init_mamba_state(cfg, b, x.device, channels=p["conv_w"].shape[1])
    xi, z = TPM.col(tp, p["in_proj"], x).chunk(2, dim=-1)  # (B, T, di)
    # Depthwise causal conv along T, warm-started from the cached window;
    # the products and partial sums rounded in the JAX package's order.
    xpad = torch.cat([state["conv"], xi], dim=1)                 # (B, T+kw-1, di)
    xc = xpad[:, 0:t] * p["conv_w"][0]
    for i in range(1, kw):
        xc = xc + xpad[:, i:i + t] * p["conv_w"][i]
    xc = F.silu(xc + p["conv_b"])

    dt, b_ssm, c_ssm = _mamba_ssm_inputs(p, cfg, xc, tp)
    a = -torch.exp(p["a_log"])                                   # (di, N)
    xc32 = _wide(xc)
    da = torch.exp(dt[..., None] * a)                            # (B, T, di, N)
    dbx = dt[..., None] * b_ssm[:, :, None, :] * xc32[..., None]
    h = state["ssm"]
    ys = []
    # The steps' slices by unbind, not by index: the backward of T index
    # slices would add T zero-filled (B, T, di, N) gradients, T^2 bytes.
    for da_i, dbx_i, c_i in zip(da.unbind(1), dbx.unbind(1), c_ssm.unbind(1)):
        h = da_i * h + dbx_i                                     # (B, di, N)
        ys.append(torch.einsum("bdn,bn->bd", h, c_i))
    y = torch.stack(ys, dim=1) + xc32 * p["d_skip"]
    out = TPM.row(tp, p["out_proj"], y.to(x.dtype) * F.silu(z))
    conv = xpad[:, -(kw - 1):] if kw > 1 else state["conv"]
    return out, {"ssm": h, "conv": conv}


def init_mamba_state(cfg: ArchConfig, batch: int, device, channels: int | None = None):
    """Zero states over `channels` (default all d_inner; e.g. a rank's)."""
    di = channels or cfg.mamba_d_inner
    return {
        "ssm": torch.zeros(batch, di, cfg.mamba_d_state, dtype=torch.float32, device=device),
        "conv": torch.zeros(batch, cfg.mamba_d_conv - 1, di, dtype=DTYPE, device=device),
    }


def mamba_decode(p, cfg: ArchConfig, x, state):
    """One token: `mamba_forward` at T = 1 with the carried conv window."""
    return mamba_forward(p, cfg, x, state)
