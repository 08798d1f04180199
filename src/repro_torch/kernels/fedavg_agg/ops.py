"""K3: the eq.-34 weighted FedAvg mean — wrappers of the CUDA kernel.

  fedavg_aggregate      -- stacked (K, N), weights (K,) -> (N,): the wrapper
                           of `agg_kernel` (csrc/fedavg_agg.cu), which
                           replaces the Pallas kernel
                           `kernels/fedavg_agg/kernel.py::_agg_kernel`;
  fedavg_aggregate_tree -- a dict of (K, ...) leaves aggregated in one
                           launch over their concatenation;
  fedavg_agg_plain      -- the plain torch version (`.ref`).

A CUDA tensor launches the kernel; a CPU tensor runs the plain version.
"""
from __future__ import annotations

import torch

from .._build import check_launch, load_fedavg
from .ref import fedavg_agg_plain

__all__ = ["fedavg_aggregate", "fedavg_aggregate_tree", "fedavg_agg_plain"]

# The kernel keeps the K normalised weights in dynamic shared memory, which
# a launch may size up to 48 KB without opting in.
MAX_SLOTS = 48 * 1024 // 4


def fedavg_aggregate(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """stacked (K, N), weights (K,) -> (N,) weighted mean over the slots.

    On the card both are contiguous float32 on one device, with
    1 <= K <= MAX_SLOTS; anything else raises."""
    if stacked.device.type == "cpu":
        return fedavg_agg_plain(stacked, weights)
    if stacked.device.type != "cuda":
        raise ValueError(f"fedavg_aggregate: unsupported device {stacked.device}")
    if stacked.dtype != torch.float32 or stacked.ndim != 2:
        raise ValueError(f"fedavg_aggregate: stacked must be (K, N) float32, "
                         f"got {tuple(stacked.shape)} {stacked.dtype}")
    k, n = stacked.shape
    if not 1 <= k <= MAX_SLOTS:
        raise ValueError(f"fedavg_aggregate: K={k} slots, need 1 <= K <= {MAX_SLOTS}")
    if (not isinstance(weights, torch.Tensor) or weights.shape != (k,)
            or weights.dtype != torch.float32 or weights.device != stacked.device):
        raise ValueError(f"fedavg_aggregate: weights must be a ({k},) float32 "
                         f"tensor on {stacked.device}")
    for name, x in (("stacked", stacked), ("weights", weights)):
        if not x.is_contiguous():
            raise ValueError(f"fedavg_aggregate: {name} is not contiguous")
    out = torch.empty(n, dtype=torch.float32, device=stacked.device)
    if n == 0:
        return out
    lib = load_fedavg()
    with torch.cuda.device(stacked.device):
        err = lib.fedavg_agg_f32(stacked.data_ptr(), weights.data_ptr(), out.data_ptr(),
                                 k, n, torch.cuda.current_stream(stacked.device).cuda_stream)
    check_launch(err, "fedavg_aggregate")
    fedavg_aggregate.launches += 1
    return out


fedavg_aggregate.launches = 0


def fedavg_aggregate_tree(client_params: dict, weights: torch.Tensor) -> dict:
    """client_params: dict of (K, ...) leaves.  Returns the aggregated dict
    (eq. 34), from one kernel launch over the leaves' float32
    concatenation."""
    leaves = list(client_params.values())
    k = leaves[0].shape[0]
    flat = torch.cat([x.reshape(k, -1).to(torch.float32) for x in leaves], dim=1)
    agg = fedavg_aggregate(flat, weights)
    out, off = {}, 0
    for name, x in client_params.items():
        size = x[0].numel()
        out[name] = agg[off:off + size].reshape(x.shape[1:]).to(x.dtype)
        off += size
    return out
