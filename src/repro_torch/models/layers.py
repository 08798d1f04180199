"""Model-zoo building blocks (PyTorch copy of the JAX package's
`models/layers.py`, the parts the ported families use).

Parameter convention as in the JAX package: every weight matrix is stored
(fan_in, fan_out) in bf16, norms in f32; compute runs in bf16 with f32
norm and rotary arithmetic.  Parameters are plain dicts of tensors, so a
JAX tree maps onto them leaf by leaf (`transformer.params_from_jax`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "DTYPE",
    "MetaGenerator",
    "normal_bf16",
    "dense_init",
    "dense",
    "rmsnorm_init",
    "rmsnorm",
    "swiglu_init",
    "swiglu",
    "rope_freqs",
    "apply_rope",
    "apply_mrope",
    "mrope_grid",
]

DTYPE = torch.bfloat16
# Draws are made in slices of about DRAW_SLICE_ELEMS elements along their
# first axis, so that the f32 temporary stays small beside the model on the
# card (deepseek-v3's (256, 7168, 2048) expert stack would be 15 GB in f32).
DRAW_SLICE_ELEMS = 1 << 28


class MetaGenerator:
    """Stands in for a torch.Generator where parameters are built as shapes
    only: its device is "meta", so every init helper returns tensors on the
    meta device, and `normal_bf16` draws nothing (the port's counterpart of
    `jax.eval_shape(init_params)`; `transformer.param_shapes`)."""

    device = torch.device("meta")


def normal_bf16(gen: torch.Generator | MetaGenerator, shape, scale: float) -> torch.Tensor:
    """Normal(0, 1) * scale drawn in f32 on `gen`'s device, stored bf16; on
    the meta device (`MetaGenerator`) an empty tensor of that shape."""
    shape = tuple(shape)
    out = torch.empty(shape, dtype=DTYPE, device=gen.device)
    if out.is_meta:
        return out
    step = max(1, DRAW_SLICE_ELEMS // max(1, math.prod(shape[1:])))
    for i in range(0, shape[0], step):
        part = torch.randn((min(step, shape[0] - i),) + shape[1:], generator=gen,
                           device=gen.device)
        out[i:i + part.shape[0]].copy_(part.mul_(scale))
    return out


def dense_init(gen: torch.Generator, n_in: int, n_out: int, *, bias: bool = False,
               scale: float | None = None):
    """Normal(0, 1) * scale in f32, stored bf16; scale defaults to
    sqrt(2 / (n_in + n_out)), as in the JAX package."""
    scale = (2.0 / (n_in + n_out)) ** 0.5 if scale is None else scale
    p = {"w": normal_bf16(gen, (n_in, n_out), scale)}
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


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, theta: float,
                sections=(16, 24, 24)) -> torch.Tensor:
    """qwen2-VL multimodal RoPE: the head dim's frequency slots are split
    into (temporal, height, width) sections, each rotated by its own
    position stream, then as `apply_rope`.

    x: (B, S, H, Dh); positions_3d: (B, S, 3) integer tensor.  `sections`
    are in frequency pairs and sum to Dh // 2.  Each slot's angle is its
    stream's position in f32 times its inverse frequency, as the JAX
    package's gather does; slicing the streams takes no index tensor."""
    dh = x.shape[-1]
    if sum(sections) != dh // 2:
        raise ValueError(f"apply_mrope: sections {tuple(sections)} do not sum to Dh/2 = "
                         f"{dh // 2}")
    inv = rope_freqs(dh, theta, x.device)                         # (Dh/2,)
    pos = positions_3d.float()                                    # (B, S, 3)
    ang, start = [], 0
    for i, n in enumerate(sections):
        ang.append(pos[..., i:i + 1] * inv[start:start + n])
        start += n
    ang = torch.cat(ang, dim=-1)                                  # (B, S, Dh/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    return _rot(x.float(), cos, sin).to(x.dtype)


def mrope_grid(batch: int, seq: int, n_patches: int, device=None) -> torch.Tensor:
    """(B, S, 3) int32 M-RoPE positions of a prompt that opens with a
    square image of `n_patches` patches, laid out as Qwen2-VL's
    `get_rope_index` does: patch (r, c) of the g x g grid at (t, h, w) =
    (0, r, c), then text token i at g + i on all three streams (one past
    the largest patch position).  Decode position p >= seq continues the
    text at g + p - n_patches."""
    g = math.isqrt(n_patches)
    if g * g != n_patches or seq < n_patches:
        raise ValueError(f"mrope_grid: n_patches={n_patches} must be a square no longer "
                         f"than seq={seq}")
    idx = torch.arange(n_patches, dtype=torch.int32, device=device)
    patches = torch.stack([torch.zeros_like(idx), idx // g, idx % g], dim=-1)
    text = torch.arange(g, g + seq - n_patches, dtype=torch.int32, device=device)
    grid = torch.cat([patches, text[:, None].expand(-1, 3)], dim=0)
    return grid[None].expand(batch, -1, -1).contiguous()
