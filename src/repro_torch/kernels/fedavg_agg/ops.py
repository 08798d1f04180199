"""K3: the eq.-34 weighted FedAvg mean — wrappers of the CUDA kernel.

  fedavg_aggregate_leaves -- a list of stacked (K, ...) leaves, weights (K,)
                             -> the list of (...) means, every leaf in one
                             launch of `agg_leaves_kernel`
                             (csrc/fedavg_agg.cu), which replaces the Pallas
                             kernel `kernels/fedavg_agg/kernel.py::_agg_kernel`;
  fedavg_aggregate        -- its one-leaf case: stacked (K, N) -> (N,);
  fedavg_aggregate_tree   -- a dict of (K, ...) leaves of any float dtype ->
                             the dict of means in those dtypes;
  fedavg_agg_plain        -- the plain torch version (`.ref`).

A CUDA tensor launches the kernel; a CPU tensor runs the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import check_launch, load_fedavg
from .ref import fedavg_agg_plain

__all__ = ["fedavg_aggregate", "fedavg_aggregate_leaves", "fedavg_aggregate_tree",
           "fedavg_agg_plain"]

# The kernel keeps the K normalised weights in dynamic shared memory, which
# a launch may size up to 48 KB without opting in.
MAX_SLOTS = 48 * 1024 // 4


@functools.cache
def _entry():
    """The C entry and the leaves one launch takes (builds on first call)."""
    lib = load_fedavg()
    return lib.fedavg_agg_leaves_f32, lib.fedavg_agg_table_leaves()


def _strides(shape) -> tuple:
    """Row-major strides of a contiguous tensor of `shape`."""
    out, step = [], 1
    for d in reversed(shape):
        out.append(step)
        step *= d
    return tuple(reversed(out))


def fedavg_aggregate_leaves(stacked: list, weights: torch.Tensor) -> list:
    """stacked: (K, ...) tensors, weights (K,) -> [x.shape[1:]] weighted
    means over the slots, 0 where every weight is 0.

    On the card every tensor is contiguous float32 on one device, with
    1 <= K <= MAX_SLOTS; anything else raises.  The outputs are views of one
    allocation, each starting on a 16-byte boundary, and one launch covers
    up to a table of non-empty leaves (64).  The host path is kept short — it runs once per aggregation of
    every engine: the leaves are read by pointer, not reshaped, and the
    stream is PyTorch's current one, read raw."""
    if not stacked:
        return []
    dev = stacked[0].device
    if dev.type == "cpu":
        return [fedavg_agg_plain(x, weights) for x in stacked]
    if dev.type != "cuda":
        raise ValueError(f"fedavg_aggregate_leaves: unsupported device {dev}")
    k = stacked[0].shape[0] if stacked[0].dim() else 0
    if not 1 <= k <= MAX_SLOTS:
        raise ValueError(f"fedavg_aggregate_leaves: stacked[0] must be (K, ...) with "
                         f"1 <= K <= {MAX_SLOTS}, got {tuple(stacked[0].shape)}")
    if (not isinstance(weights, torch.Tensor) or weights.shape != (k,)
            or weights.dtype != torch.float32 or weights.device != dev
            or not weights.is_contiguous()):
        raise ValueError(f"fedavg_aggregate_leaves: weights must be a contiguous ({k},) "
                         f"float32 tensor on {dev}")
    rows, offsets, total, n_leaves = [], [], 0, 0
    for j, x in enumerate(stacked):
        if (not isinstance(x, torch.Tensor) or x.dim() < 1 or x.shape[0] != k
                or x.dtype != torch.float32 or x.device != dev or not x.is_contiguous()):
            raise ValueError(f"fedavg_aggregate_leaves: stacked[{j}] must be a contiguous "
                             f"({k}, ...) float32 tensor on {dev}, got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
        n = x.numel() // k
        if n:
            rows += (x.data_ptr(), total, n)      # the output offset becomes a pointer below
            n_leaves += 1
        offsets.append(total)
        total += -(-n // 4) * 4          # the next output on a 16-byte boundary
    out = torch.empty(total, dtype=torch.float32, device=dev)
    means = [out.as_strided(x.shape[1:], _strides(x.shape[1:]), o)
             for x, o in zip(stacked, offsets)]
    if not n_leaves:
        return means
    base = out.data_ptr()
    for j in range(1, len(rows), 3):
        rows[j] = base + 4 * rows[j]
    fn, table = _entry()
    args = ((ctypes.c_int64 * len(rows))(*rows), n_leaves, weights.data_ptr(), k,
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    check_launch(err, "fedavg_aggregate_leaves")
    fedavg_aggregate_leaves.launches += -(-n_leaves // table)
    return means


fedavg_aggregate_leaves.launches = 0


def fedavg_aggregate(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """stacked (K, N), weights (K,) -> (N,) weighted mean over the slots:
    the one-leaf case of `fedavg_aggregate_leaves`."""
    return fedavg_aggregate_leaves([stacked], weights)[0]


def fedavg_aggregate_tree(client_params: dict, weights: torch.Tensor) -> dict:
    """client_params: dict of (K, ...) leaves.  Returns the aggregated dict
    (eq. 34), every leaf in one kernel launch, each cast back to its
    dtype."""
    means = fedavg_aggregate_leaves(
        [x.to(torch.float32).contiguous() for x in client_params.values()], weights)
    return {name: m.to(x.dtype) for (name, x), m in zip(client_params.items(), means)}
