"""Deterministic synthetic token batches for the model zoo's serving and
training paths (NumPy copy of the JAX package's `data/pipeline.py`,
bit-identical for the same seed or `np.random.Generator` state)."""
from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["synthetic_token_batch", "synthetic_lm_stream"]


def synthetic_token_batch(
    rng: np.random.Generator, batch: int, seq_len: int, vocab: int
) -> dict[str, np.ndarray]:
    """One causal-LM batch: Zipf-distributed tokens, labels = inputs shifted."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    toks = rng.choice(vocab, size=(batch, seq_len + 1), p=probs).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def synthetic_lm_stream(
    seed: int, batch: int, seq_len: int, vocab: int
) -> Iterator[dict[str, np.ndarray]]:
    """Infinite deterministic stream of LM batches."""
    rng = np.random.default_rng(seed)
    while True:
        yield synthetic_token_batch(rng, batch, seq_len, vocab)
