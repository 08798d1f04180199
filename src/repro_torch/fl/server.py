"""Server-side aggregation: the selection-masked weighted FedAvg of eq. (34).

    w^{t+1} = sum_n S_n (sum_k psi_kn) beta_n w_n / sum_n S_n (sum_k psi_kn) beta_n

If no device transmits in a round (all-infeasible corner of Prop. 1), the
global model is unchanged (weights sum to 0 -> guarded).  The synchronous
half of the JAX package's `fl/server.py`.
"""
from __future__ import annotations

import torch

__all__ = ["masked_weighted_mean", "aggregate"]


def masked_weighted_mean(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted mean over the leading axis; identity-safe at zero weight."""
    w = weights / torch.clamp_min(weights.sum(), 1e-30)
    shape = (-1,) + (1,) * (stacked.ndim - 1)
    return (stacked * w.reshape(shape)).sum(dim=0)


def aggregate(global_params: dict, client_params: dict,
              weights: torch.Tensor) -> dict:
    """Eq. (34).  client_params leaves have a leading slot axis (K, ...);
    weights (K,) = S_n * sum_k psi_kn * beta_n per slot (0 for empty slots).
    Keeps the previous global model when sum(weights) == 0."""
    keep = weights.sum() > 0
    return {k: torch.where(keep, masked_weighted_mean(client_params[k], weights),
                           g).to(g.dtype)
            for k, g in global_params.items()}
