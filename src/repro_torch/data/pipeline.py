"""Deterministic synthetic token batches for the model zoo's serving path
(NumPy copy of the JAX package's `data/pipeline.py::synthetic_token_batch`,
bit-identical for the same `np.random.Generator` state)."""
from __future__ import annotations

import numpy as np

__all__ = ["synthetic_token_batch"]


def synthetic_token_batch(
    rng: np.random.Generator, batch: int, seq_len: int, vocab: int
) -> dict[str, np.ndarray]:
    """One causal-LM batch: Zipf-distributed tokens, labels = inputs shifted."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    toks = rng.choice(vocab, size=(batch, seq_len + 1), p=probs).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
