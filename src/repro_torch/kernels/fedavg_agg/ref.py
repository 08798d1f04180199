"""The plain torch version of K3, the selection-weighted FedAvg mean of
paper eq. (34): w_new = sum_n weight_n * theta_n / sum_n weight_n, with
weight_n = S_n * (sum_k psi_kn) * beta_n and zero-weight slots ignored.

The JAX package's oracle `kernels/fedavg_agg/ref.py::fedavg_agg_ref`
computes the same weighted sum as one einsum; here every sum is written
out in slot order, as the CUDA kernel (csrc/fedavg_agg.cu) takes it, so the
two agree to the bit.
"""
from __future__ import annotations

import torch

__all__ = ["fedavg_agg_plain"]


def fedavg_agg_plain(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """stacked (K, N) client tensors (flattened params), weights (K,).
    Returns (N,) = weighted mean over the leading axis (0 if all weights 0)."""
    wsum = torch.zeros((), dtype=weights.dtype, device=weights.device)
    for w_k in weights:
        wsum = wsum + w_k
    w_hat = weights / torch.clamp_min(wsum, 1e-30)
    acc = torch.zeros(stacked.shape[1:], dtype=stacked.dtype, device=stacked.device)
    for w_k, x_k in zip(w_hat, stacked):
        acc = acc + w_k * x_k
    return acc
