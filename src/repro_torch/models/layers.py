"""Model-zoo building blocks (PyTorch copy of the JAX package's
`models/layers.py`, the parts the dense-GQA and RWKV-6 families use).

Parameter convention as in the JAX package: every weight matrix is stored
(fan_in, fan_out) in bf16, norms in f32; compute runs in bf16 with f32
norm and rotary arithmetic.  Parameters are plain dicts of tensors, so a
JAX tree maps onto them leaf by leaf (`transformer.params_from_jax`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "DTYPE",
    "dense_init",
    "dense",
    "rmsnorm_init",
    "rmsnorm",
    "swiglu_init",
    "swiglu",
    "rope_freqs",
    "apply_rope",
]

DTYPE = torch.bfloat16


def dense_init(gen: torch.Generator, n_in: int, n_out: int, *, bias: bool = False,
               scale: float | None = None):
    """Normal(0, 1) * scale in f32, stored bf16; scale defaults to
    sqrt(2 / (n_in + n_out)), as in the JAX package."""
    scale = (2.0 / (n_in + n_out)) ** 0.5 if scale is None else scale
    w = torch.randn(n_in, n_out, generator=gen, device=gen.device) * scale
    p = {"w": w.to(DTYPE)}
    if bias:
        p["b"] = torch.zeros(n_out, dtype=DTYPE, device=gen.device)
    return p


def dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(d: int, device):
    return {"g": torch.ones(d, dtype=torch.float32, device=device)}


def rmsnorm(p, x, eps: float = 1e-5):
    """RMS norm computed in f32, cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["g"]).to(x.dtype)


def swiglu_init(gen: torch.Generator, d: int, ff: int):
    return {"gate": dense_init(gen, d, ff), "up": dense_init(gen, d, ff),
            "down": dense_init(gen, ff, d)}


def swiglu(p, x):
    return dense(p["down"], F.silu(dense(p["gate"], x)) * dense(p["up"], x))


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (dim // 2,), f32."""
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def _rot(x, cos, sin):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh), positions: integer tensor broadcastable to
    (..., S).  Angles and the rotation in f32, cast back to x's dtype."""
    inv = rope_freqs(x.shape[-1], theta, x.device)               # (Dh/2,)
    ang = positions[..., None].float() * inv                     # (..., S, Dh/2)
    cos = torch.cos(ang)[..., None, :]                           # (..., S, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    return _rot(x.float(), cos, sin).to(x.dtype)
