"""The plain torch version of K5, the RWKV-6 WKV recurrence — the mirror of
the JAX package's `models/ssm.py::wkv6_scan_ref` (the oracle of its Pallas
kernel `kernels/rwkv6_wkv/kernel.py::_wkv6_kernel`), a loop over time:

    S_t[i,j] = w_t[i] * S_{t-1}[i,j] + k_t[i] * v_t[j]
    y_t[j]   = sum_i r_t[i] * (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])

The port's model calls it `wkv6_scan_ref` for `rwkv_wkv_impl="ref"`.

Where the JAX package leaves the sum over i to an einsum, this version
fixes its order: a pairwise tree (i + hs/2, then i + hs/4, ...), which the
CUDA kernel (csrc/rwkv6_wkv.cu) takes too, with the same rounded
multiplies and adds, so the two agree to the bit.  That matters for the
model, not for the recurrence: with random weights at full width, the
per-head normalisation after the WKV turns f32 rounding differences in a
head's nearly cancelling sums into bf16 rounding flips, which grow over
the layers (PERF.md, section 6).
"""
from __future__ import annotations

import torch

__all__ = ["wkv6_plain"]


def _tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over `dim` (a power of two long) by halves: x[:h] + x[h:], ..."""
    while x.shape[dim] > 1:
        h = x.shape[dim] // 2
        x = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
    return x.squeeze(dim)


def wkv6_plain(r, k, v, w, u, state):
    """r, k, v, w: (B, T, H, hs) f32, w the decay in (0, 1); u: (H, hs);
    state: (B, H, hs, hs) f32 mapping k-dim -> v-dim; hs a power of two.
    Returns y (B, T, H, hs) and the final state."""
    s = state
    ys = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]       # (B, H, hs)
        kv = k_t[..., :, None] * v_t[..., None, :]                      # (B, H, hs, hs)
        a = s + u[None, :, :, None] * kv
        ys.append(_tree_sum(r_t[..., :, None] * a, dim=-2))             # sum over i
        s = w_t[..., None] * s + kv
    return torch.stack(ys, dim=1), s
