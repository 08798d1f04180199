"""Serving steps of the model zoo (PyTorch copy of the JAX package's
`train/train_step.py::make_prefill_step` / `make_serve_step`; the training
step is `train_step.py`)."""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models.transformer import decode_step, forward

__all__ = ["make_prefill_step", "make_serve_step"]


def make_prefill_step(cfg: ArchConfig, *, cache_headroom: int = 0):
    """prefill_step(params, batch) -> (last_logits (B, 1, V), cache), the
    cache with `cache_headroom` free decode slots."""

    def prefill_step(params, batch):
        logits, _, cache = forward(cfg, params, batch, mode="prefill",
                                   cache_headroom=cache_headroom)
        return logits[:, -1:], cache

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """serve_step(params, batch, cache) -> (next_token (B, 1) int32, logits,
    cache): ONE new token against the cache, greedy, on the parameters'
    device.  The cache is updated in place (`decode_step`)."""

    def serve_step(params, batch, cache):
        logits, cache = decode_step(cfg, params, batch, cache)
        next_tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, cache

    return serve_step
