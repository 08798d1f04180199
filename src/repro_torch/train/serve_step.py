"""Serving steps of the model zoo (PyTorch copy of the JAX package's
`train/train_step.py::make_prefill_step` / `make_serve_step`; the training
step is `train_step.py`).

With a meshed `ctx` (`sharding.ctx.ShardCtx`), as the JAX factories take
one: the parameters are this rank's blocks, the batch its data shard, and
the cache this rank's block of every leaf `sharding.partition.
cache_shardings` shards over `model` (the cache length of the attention
caches, the heads or channels of the recurrent states; the prefill returns
it in that layout and the decode step reads and writes it in place).  The
logits the steps return are whole over the vocab (the last position's
only: they are small), gathered from the ranks' vocab blocks where the
model's logits are vocab-parallel, and the greedy token is the argmax over
all ranks' blocks (`greedy_token`).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models.transformer import decode_step, forward, vocab_parallel, whole_logits
from ..sharding import comm
from ..sharding.partition import MODEL_AXIS

__all__ = ["make_prefill_step", "make_serve_step", "greedy_token"]


def greedy_token(cfg: ArchConfig, logits: torch.Tensor, ctx=None) -> torch.Tensor:
    """argmax over the vocab of `logits` (..., V), as int64 (...,); of
    vocab-parallel logits (..., V / model) each rank's (max, index) pair
    combined over `model`: the largest value, on ties the lowest global
    index, as `argmax` gives it."""
    idx = logits.argmax(dim=-1)
    if not vocab_parallel(cfg, ctx):
        return idx
    group = ctx.group(MODEL_AXIS)
    val = torch.gather(logits, -1, idx[..., None])[..., 0]
    best = comm.all_reduce_max_(val.clone(), group)
    cand = torch.where(val == best, idx + ctx.rank(MODEL_AXIS) * logits.shape[-1],
                       torch.full_like(idx, torch.iinfo(idx.dtype).max))
    return comm.all_reduce_min_(cand, group)


def make_prefill_step(cfg: ArchConfig, *, cache_headroom: int = 0, ctx=None):
    """prefill_step(params, batch) -> (last_logits (B, 1, V), cache), the
    cache with `cache_headroom` free decode slots (on a mesh in its
    `cache_shardings` layout)."""

    def prefill_step(params, batch):
        logits, _, cache = forward(cfg, params, batch, mode="prefill",
                                   cache_headroom=cache_headroom, ctx=ctx)
        return whole_logits(cfg, logits[:, -1:], ctx), cache

    return prefill_step


def make_serve_step(cfg: ArchConfig, ctx=None):
    """serve_step(params, batch, cache) -> (next_token (B, 1) int32, logits
    (B, 1, V), cache): ONE new token against the cache, greedy, on the
    parameters' device.  The cache is updated in place (`decode_step`)."""

    def serve_step(params, batch, cache):
        logits, cache = decode_step(cfg, params, batch, cache, ctx)
        next_tok = greedy_token(cfg, logits[:, -1], ctx).to(torch.int32)[:, None]
        return next_tok, whole_logits(cfg, logits, ctx), cache

    return serve_step
