"""The plain torch version of K4, the flash-attention kernel.

It computes the function of the Pallas kernel body
(`kernels/flash_attention/kernel.py::flash_attention_kernel`), not that of
the JAX package's oracle `attention_ref`: scores, softmax and the P.V
product all in f32, one cast to q's dtype at the end (`attention_ref`
casts the probabilities to v's dtype before P.V).  Queries are
right-aligned (query i sits at position i + Sk - Sq), masked scores are
NEG_INF = -1e30 as in the kernel, the denominator is max(l, 1e-30), and
query head h reads KV head h // G (G = Hq / Hkv), as the JAX wrapper's
`jnp.repeat(..., G, axis=1)` arranges it.
"""
from __future__ import annotations

import torch

__all__ = ["NEG_INF", "flash_attention_plain"]

NEG_INF = -1e30


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: float | None = None):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q.dtype."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d**-0.5 if scale is None else scale
    qg = q.float().reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    cols = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= cols > rows - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float()) / l.clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
