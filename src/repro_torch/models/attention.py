"""Grouped-query attention (PyTorch copy of the GQA part of the JAX
package's `models/attention.py`): QKV bias, RoPE, sliding window, chunked
softmax for long prefill, and the ring-buffer decode cache.

Grouped heads never materialize the repeated K/V: queries are reshaped to
(B, S, Hkv, G, Dh) and contracted against (B, S, Hkv, Dh) directly.

Caches (decode path) are ring buffers:
    {"k": (B, C, Hkv, Dh), "v": (B, C, Hkv, Dh), "pos": (C,) int32 global
     positions (-1 = empty), "idx": () int32 next write slot}
K is stored *with RoPE applied at its true position*, so decode never
re-rotates the cache.  Sliding-window configs simply allocate C = window.

Unlike the JAX package's functional cache, `gqa_decode` writes the new
token's K/V, position and write index into the cache IN PLACE (the cache
is the decode step's largest state; a copy per step would move all of it).
A caller that wants to keep the old cache passes a clone.

`attn_impl="pallas"` runs prefill attention through the flash-attention
wrapper (K4: the CUDA kernel on the card, its plain version for CPU
tensors); `"ref"` keeps the JAX package's plain path (`_full_attn`).
Decode attention over the ring is plain torch ops in both, as in the JAX
package.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..kernels.flash_attention.ops import flash_attention
from .layers import DTYPE, apply_rope, dense, dense_init

__all__ = ["gqa_init", "gqa_forward", "gqa_decode", "init_kv_cache"]

NEG_INF = -1e30


# --------------------------------------------------------------------------
# Core softmax attention on grouped heads.
# --------------------------------------------------------------------------

def _sdpa(q, k, v, mask, scale):
    """q: (B,Sq,Hkv,G,Dh); k,v: (B,Sk,Hkv,Dh); mask: broadcastable to
    (B,Hkv,G,Sq,Sk) or None.  Probabilities are cast to v's dtype before
    P.V, as in the JAX package."""
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)


def _causal_mask(sq: int, sk: int, q_offset, window: int, device):
    """(1,1,1,Sq,Sk) boolean; window = 0 means full causal."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    kj = torch.arange(sk, device=device)[None, :]
    m = kj <= qi
    if window > 0:
        m &= kj > qi - window
    return m[None, None, None]


def _chunked_sdpa(q, k, v, scale, window: int, chunk: int):
    """Flash-style: a loop over query chunks (the JAX package's lax.scan);
    peak memory per step is (B,Hkv,G,chunk,Sk) instead of (...,Sq,Sk)."""
    sq = q.shape[1]
    assert sq % chunk == 0, (sq, chunk)
    outs = []
    for i in range(sq // chunk):
        mask = _causal_mask(chunk, k.shape[1], i * chunk, window, q.device)
        outs.append(_sdpa(q[:, i * chunk:(i + 1) * chunk], k, v, mask, scale))
    return torch.cat(outs, dim=1)


def _full_attn(qg, k, v, scale, window: int, chunk: int):
    """Dispatch: chunked loop for long sequences, one-shot otherwise."""
    s = qg.shape[1]
    if chunk and s > 2 * chunk:
        return _chunked_sdpa(qg, k, v, scale, window, chunk)
    mask = _causal_mask(s, k.shape[1], 0, window, qg.device)
    return _sdpa(qg, k, v, mask, scale)


# --------------------------------------------------------------------------
# GQA
# --------------------------------------------------------------------------

def gqa_init(gen: torch.Generator, cfg: ArchConfig):
    dh = cfg.head_dim
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * dh, bias=cfg.qkv_bias),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * dh, bias=cfg.qkv_bias),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * dh, bias=cfg.qkv_bias),
        "wo": dense_init(gen, cfg.n_heads * dh, cfg.d_model),
    }


def _project_qkv(p, cfg: ArchConfig, x, positions):
    b, s, _ = x.shape
    dh = cfg.head_dim
    q = dense(p["wq"], x).reshape(b, s, cfg.n_heads, dh)
    k = dense(p["wk"], x).reshape(b, s, cfg.n_kv_heads, dh)
    v = dense(p["wv"], x).reshape(b, s, cfg.n_kv_heads, dh)
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def gqa_forward(p, cfg: ArchConfig, x, *, positions=None, chunk: int = 0,
                return_kv: bool = False):
    """Training / prefill self-attention (causal, optional sliding window).

    With return_kv=True also returns the rotated (k, v) so the serving path
    can seed a decode cache from prefill."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    if cfg.attn_impl == "pallas":
        out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    else:
        qg = q.reshape(b, s, hkv, cfg.n_heads // hkv, dh)
        out = _full_attn(qg, k, v, dh**-0.5, cfg.sliding_window, chunk)
    y = dense(p["wo"], out.reshape(b, s, cfg.n_heads * dh))
    if return_kv:
        return y, (k, v)
    return y


def init_kv_cache(cfg: ArchConfig, batch: int, cache_len: int, device):
    dh = cfg.head_dim
    return {
        "k": torch.zeros(batch, cache_len, cfg.n_kv_heads, dh, dtype=DTYPE, device=device),
        "v": torch.zeros(batch, cache_len, cfg.n_kv_heads, dh, dtype=DTYPE, device=device),
        "pos": torch.full((cache_len,), -1, dtype=torch.int32, device=device),
        "idx": torch.zeros((), dtype=torch.int32, device=device),
    }


def gqa_decode(p, cfg: ArchConfig, x, cache, cur_pos):
    """One-token decode: x (B, 1, d); cur_pos a () int32 tensor, the global
    position, on x's device (no host read).  Writes slot idx % C of the
    cache in place, advances its idx, and returns (y, cache)."""
    b = x.shape[0]
    dh = cfg.head_dim
    hkv = cfg.n_kv_heads
    g = cfg.n_heads // hkv
    positions = cur_pos.reshape(1, 1).expand(b, 1)
    q, k, v = _project_qkv(p, cfg, x, positions)

    c = cache["k"].shape[1]
    slot = (cache["idx"] % c).reshape(1).long()
    cache["k"].index_copy_(1, slot, k)
    cache["v"].index_copy_(1, slot, v)
    cache["pos"].index_copy_(0, slot, cur_pos.reshape(1).to(torch.int32))
    cache["idx"].add_(1)

    new_pos = cache["pos"]
    valid = (new_pos >= 0) & (new_pos <= cur_pos)
    if cfg.sliding_window > 0:
        valid &= new_pos > cur_pos - cfg.sliding_window
    mask = valid[None, None, None, None, :]                    # (1,1,1,1,C)

    qg = q.reshape(b, 1, hkv, g, dh)
    out = _sdpa(qg, cache["k"], cache["v"], mask, dh**-0.5)
    y = dense(p["wo"], out.reshape(b, 1, cfg.n_heads * dh))
    return y, cache
