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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.rwkv6_wkv.ref import wkv6_plain as wkv6_scan_ref
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


def _rwkv6_mix(p, cfg: ArchConfig, x, prev_tok):
    """Shared pre-recurrence projections. Returns r,k,v,w (B,T,H,hs) f32,
    g (B,T,d)."""
    b, t, _ = x.shape
    h, hs = cfg.n_rwkv_heads, cfg.rwkv_head_size
    xx = _shift(x, prev_tok)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (x + (xx - x) * mu[i] for i in range(5))
    r = dense(p["wr"], xr).reshape(b, t, h, hs).float()
    k = dense(p["wk"], xk).reshape(b, t, h, hs).float()
    v = dense(p["wv"], xv).reshape(b, t, h, hs).float()
    g = F.silu(dense(p["wg"], xg))
    # Data-dependent decay (Finch): w_t = exp(-exp(w0 + lora(xw))).
    w_log = p["w0"] + dense(p["w_lora_b"], torch.tanh(dense(p["w_lora_a"], xw))).float()
    w = torch.exp(-torch.exp(w_log)).reshape(b, t, h, hs)
    return r, k, v, w, g


def _rwkv6_out(p, cfg: ArchConfig, y, g, b, t):
    d = cfg.d_model
    # Per-head group normalization, folded to RMS over each head's channels.
    yh = y.reshape(b, t, cfg.n_rwkv_heads, cfg.rwkv_head_size).float()
    yh = yh * torch.rsqrt(yh.square().mean(-1, keepdim=True) + 1e-5)
    yf = (yh.reshape(b, t, d) * p["ln_x"]["g"]).to(g.dtype)
    return dense(p["wo"], yf * g)


def rwkv6_time_mix(p, cfg: ArchConfig, x, state, *, wkv_impl=wkv6_scan_ref):
    """Time-mix (attention replacement) over a full sequence. x: (B, T, d).

    state: {"wkv": (B,H,hs,hs) f32, "prev_tok": (B,d)}.  Works for T == 1
    (decode) and any prefill length; returns (out, new state) and leaves
    `state` as it was."""
    b, t, _ = x.shape
    r, k, v, w, g = _rwkv6_mix(p, cfg, x, state["prev_tok"])
    y, s_new = wkv_impl(r, k, v, w, p["u"], state["wkv"])
    out = _rwkv6_out(p, cfg, y, g, b, t)
    return out, {"wkv": s_new, "prev_tok": x[:, -1, :]}


def rwkv6_channel_mix(p, cfg: ArchConfig, x, prev_tok):
    """Channel-mix (FFN replacement). Returns (y, new prev_tok (B, d))."""
    xx = _shift(x, prev_tok)
    mu_c = p["mu_c"].to(x.dtype)
    xk = x + (xx - x) * mu_c[0]
    xr = x + (xx - x) * mu_c[1]
    y = torch.sigmoid(dense(p["cr"], xr)) * dense(
        p["cv"], torch.square(torch.relu(dense(p["ck"], xk))))
    return y, x[:, -1, :]


def init_rwkv6_state(cfg: ArchConfig, batch: int, device):
    h, hs = cfg.n_rwkv_heads, cfg.rwkv_head_size
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


def _mamba_ssm_inputs(p, cfg: ArchConfig, xc):
    """xc: conv + silu output (B, T, di).  Returns dt (B, T, di) f32 and
    b, c (B, T, N) f32."""
    n = cfg.mamba_d_state
    dt_rank = p["dt_proj"]["w"].shape[0]
    dt_low, b_ssm, c_ssm = torch.split(dense(p["x_proj"], xc), [dt_rank, n, n], dim=-1)
    dt = F.softplus(dense(p["dt_proj"], dt_low).float() + p["dt_bias"])
    return dt, b_ssm.float(), c_ssm.float()


def mamba_forward(p, cfg: ArchConfig, x, state=None):
    """x: (B, T, d); state {"ssm": (B, di, N) f32, "conv": (B, kw - 1, di)},
    zeros when None.  Full-sequence selective scan; returns (out, new state)
    and leaves `state` as it was.  T = 1 is the decode step."""
    b, t, _ = x.shape
    kw = cfg.mamba_d_conv
    if state is None:
        state = init_mamba_state(cfg, b, x.device)
    xi, z = dense(p["in_proj"], x).chunk(2, dim=-1)               # (B, T, di)
    # Depthwise causal conv along T, warm-started from the cached window;
    # the products and partial sums rounded in the JAX package's order.
    xpad = torch.cat([state["conv"], xi], dim=1)                 # (B, T+kw-1, di)
    xc = xpad[:, 0:t] * p["conv_w"][0]
    for i in range(1, kw):
        xc = xc + xpad[:, i:i + t] * p["conv_w"][i]
    xc = F.silu(xc + p["conv_b"])

    dt, b_ssm, c_ssm = _mamba_ssm_inputs(p, cfg, xc)
    a = -torch.exp(p["a_log"])                                   # (di, N)
    xc32 = xc.float()
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
    out = dense(p["out_proj"], y.to(x.dtype) * F.silu(z))
    conv = xpad[:, -(kw - 1):] if kw > 1 else state["conv"]
    return out, {"ssm": h, "conv": conv}


def init_mamba_state(cfg: ArchConfig, batch: int, device):
    return {
        "ssm": torch.zeros(batch, cfg.mamba_d_inner, cfg.mamba_d_state, dtype=torch.float32,
                           device=device),
        "conv": torch.zeros(batch, cfg.mamba_d_conv - 1, cfg.mamba_d_inner, dtype=DTYPE,
                            device=device),
    }


def mamba_decode(p, cfg: ArchConfig, x, state):
    """One token: `mamba_forward` at T = 1 with the carried conv window."""
    return mamba_forward(p, cfg, x, state)
