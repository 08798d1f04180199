"""K3: the eq.-34 weighted FedAvg mean — wrappers of the CUDA kernel.

  fedavg_aggregate_leaves -- a list of stacked (K, ...) leaves, weights (K,)
                             -> the list of (...) means, every leaf in one
                             launch of `agg_leaves_kernel`
                             (csrc/fedavg_agg.cu), which replaces the Pallas
                             kernel `kernels/fedavg_agg/kernel.py::_agg_kernel`;
  fedavg_aggregate_leaves_batched
                          -- the same with a leading cell axis: (B, K, ...)
                             leaves, weights (B, K) -> (B, ...) means, every
                             leaf of every cell in one launch, laid out by
                             `cell_buffers`;
  fedavg_aggregate        -- its one-leaf case: stacked (K, N) -> (N,);
  fedavg_aggregate_tree   -- a dict of (K, ...) leaves of any float dtype ->
                             the dict of means in those dtypes;
  fedavg_agg_plain        -- the plain torch version (`.ref`; its cell-axis
                             form `fedavg_agg_plain_cells`);
  cell_buffers            -- (B, ...) float32 tensors of one allocation in
                             which every (cell, leaf) block starts on a
                             512-byte boundary.

A CUDA tensor launches the kernel; a CPU tensor runs the plain version.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .._build import check_launch, count_launches, load_fedavg
from .ref import fedavg_agg_plain, fedavg_agg_plain_cells

__all__ = ["fedavg_aggregate", "fedavg_aggregate_leaves",
           "fedavg_aggregate_leaves_batched", "fedavg_aggregate_tree",
           "fedavg_agg_plain", "cell_buffers"]

# The kernel keeps the K normalised weights in dynamic shared memory, which
# a launch may size up to 48 KB without opting in.
MAX_SLOTS = 48 * 1024 // 4
# A (cell, leaf) block of `cell_buffers` starts on a multiple of this many
# floats: 512 bytes, the CUDA caching allocator's own alignment.
CELL_ALIGN = 128


@functools.cache
def _entry():
    """The library, the leaves one launch takes and the cells one launch
    takes (builds on first call)."""
    lib = load_fedavg()
    return lib, lib.fedavg_agg_table_leaves(), lib.fedavg_agg_max_cells()


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
    lib, table, _ = _entry()
    _launch(lib.fedavg_agg_leaves_f32, dev, (ctypes.c_int64 * len(rows))(*rows), n_leaves,
            weights.data_ptr(), k)
    count_launches(fedavg_aggregate_leaves, -(-n_leaves // table))
    return means


fedavg_aggregate_leaves.launches = 0


def _launch(fn, dev: torch.device, *args) -> None:
    """Call a C entry on PyTorch's current stream of `dev` (read raw)."""
    args = args + (torch._C._cuda_getCurrentRawStream(dev.index),)
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    check_launch(err, fn.__name__)


def cell_buffers(shapes, cells: int, device) -> list:
    """A (cells, *shape) float32 tensor per shape, all views of one
    allocation in which every (cell, leaf) block starts on a multiple of
    CELL_ALIGN floats (512 bytes): a leaf's row stride is its size rounded
    up to that.  A cell's view of a leaf is then contiguous and aligned as
    a fresh allocation is, so libraries that pick their algorithm by a
    pointer's alignment (cuBLAS, MKL) treat every cell alike."""
    out, off = [], 0
    sizes = [math.prod(s) for s in shapes]
    rows = [-(-n // CELL_ALIGN) * CELL_ALIGN for n in sizes]
    buf = torch.empty(cells * sum(rows), dtype=torch.float32, device=device)
    for shape, row in zip(shapes, rows):
        out.append(buf.as_strided((cells,) + tuple(shape), (row,) + _strides(shape), off))
        off += cells * row
    return out


def fedavg_aggregate_leaves_batched(stacked: list, weights: torch.Tensor) -> list:
    """stacked: (B, K, ...) tensors, weights (B, K) -> [(B,) + x.shape[2:]]
    weighted means over the slots of each cell, 0 for a cell whose weights
    are all 0; each cell's means are the bits `fedavg_aggregate_leaves`
    gives for that cell alone.

    The outputs are `cell_buffers(...)` views.  A CPU tensor runs the plain
    version (`fedavg_agg_plain_cells`, once per cell).  On the card every tensor is contiguous float32
    on one device, 1 <= K <= MAX_SLOTS and 1 <= B <= the grid's limit
    (65 535), else it raises; one launch of `agg_leaves_kernel` covers every
    cell of up to a table of non-empty leaves (64)."""
    if not stacked:
        return []
    dev = stacked[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fedavg_aggregate_leaves_batched: unsupported device {dev}")
    if stacked[0].dim() < 2:
        raise ValueError("fedavg_aggregate_leaves_batched: stacked[0] must be (B, K, ...), "
                         f"got {tuple(stacked[0].shape)}")
    b, k = stacked[0].shape[:2]
    means = cell_buffers([x.shape[2:] for x in stacked], b, dev)
    if dev.type == "cpu":
        for m, x in zip(means, stacked):
            m.copy_(fedavg_agg_plain_cells(x, weights))
        return means
    lib, table, max_cells = _entry()
    if not (1 <= k <= MAX_SLOTS and 1 <= b <= max_cells):
        raise ValueError(f"fedavg_aggregate_leaves_batched: stacked[0] must be (B, K, ...) "
                         f"with 1 <= K <= {MAX_SLOTS}, 1 <= B <= {max_cells}, got "
                         f"{tuple(stacked[0].shape)}")
    if (not isinstance(weights, torch.Tensor) or weights.shape != (b, k)
            or weights.dtype != torch.float32 or weights.device != dev
            or not weights.is_contiguous()):
        raise ValueError(f"fedavg_aggregate_leaves_batched: weights must be a contiguous "
                         f"({b}, {k}) float32 tensor on {dev}")
    rows, n_leaves = [], 0
    for j, (x, m) in enumerate(zip(stacked, means)):
        if (not isinstance(x, torch.Tensor) or x.dim() < 2 or x.shape[:2] != (b, k)
                or x.dtype != torch.float32 or x.device != dev or not x.is_contiguous()):
            raise ValueError(f"fedavg_aggregate_leaves_batched: stacked[{j}] must be a "
                             f"contiguous ({b}, {k}, ...) float32 tensor on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
        n = x.numel() // (b * k)
        if n:
            rows += (x.data_ptr(), m.data_ptr(), n, m.stride(0))
            n_leaves += 1
    if n_leaves:
        _launch(lib.fedavg_agg_cells_f32, dev, (ctypes.c_int64 * len(rows))(*rows),
                n_leaves, weights.data_ptr(), k, b)
        count_launches(fedavg_aggregate_leaves_batched, -(-n_leaves // table))
    return means


fedavg_aggregate_leaves_batched.launches = 0


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
