"""Collectives with the gradients a per-rank model needs (the megatron
operators), over a `torch.distributed` process group.

The port's meshed model keeps the residual stream replicated over the
`model` axis, so downstream of any of these the same computation runs on
every model rank and every rank's gradient of a replicated tensor is
complete.  Each operator's backward is the one that keeps that true:

  copy_to(x)      identity;          backward all-reduce (sum): a tensor
                                     used by per-rank partial work (the
                                     experts held here, the heads or query
                                     rows taken here) gathers its gradient;
  reduce_from(x)  all-reduce (sum);  backward identity: partial outputs
                                     (each rank's experts) combined;
  mean_from(x)    all-reduce mean;   backward grad / n;
  split_to(x, d)  this rank's block of dim d;  backward all-gather;
  gather_from(x, d) all-gather on dim d;       backward this rank's block;
  all_reduce(x)   all-reduce (sum);  backward all-reduce (sum): a
                                     statistic summed over data shards
                                     that every shard's loss reads;
  copy_to_f32(x)  `copy_to` whose backward sums in float32 and rounds
                                     once.

The tensor-parallel products (megatron's column- and row-parallel dense
layers, for `models.tensor_parallel`).  A row-parallel output's partials
are summed over `model` in float32 and rounded once, as the unsharded
product rounds its dot products once (a bf16 sum of bf16-rounded partials
rounds twice).  A partial is a product with the weights' inputs and a
float32 output (`_mm_f32`: on the card bf16 tensor cores accumulating in
float32, never a float32 copy of a weight):

  col_parallel(x, [(w, b), ...])  x @ w_i + b_i for column blocks w_i of
                                     projections reading one replicated x;
                                     backward: x's partial gradients
                                     sum_i g_i w_i^T, rounded to x's dtype,
                                     all-reduced (one call);
  row_parallel(x, w)              x @ w for a row block w and x this
                                     rank's columns: the partial products
                                     all-reduced; backward local;
  row_scatter(x, w)               row_parallel's sum reduce-scattered onto
                                     this rank's block of the output's
                                     columns; backward all-gather.

`all_reduce_` (sum), `all_reduce_max_` and `all_reduce_min_` reduce in
place with no gradient: a decode step's softmax statistics and greedy
token, the max a log-softmax subtracts (its gradient cancels).

Every collective runs as called, whatever the group's size, so a world
of one takes the same path as a mesh of many.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["copy_to", "copy_to_f32", "reduce_from", "mean_from", "split_to", "gather_from",
           "all_reduce", "col_parallel", "row_parallel", "row_scatter", "all_reduce_",
           "all_reduce_max_", "all_reduce_min_", "gather_"]


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over `group` (no autograd), returned."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_reduce_max_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place max over `group` (no autograd), returned."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def all_reduce_min_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place min over `group` (no autograd), returned."""
    dist.all_reduce(x, op=dist.ReduceOp.MIN, group=group)
    return x


def gather_(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' blocks of `x` concatenated on `dim` (no autograd)."""
    return _gather(x, group, dim)


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return x.chunk(n, dim=dim)[r].contiguous()


def _reduce_scatter_last(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group` of x, this rank's block of its last dim."""
    n = dist.get_world_size(group)
    full = x.movedim(-1, 0).contiguous()
    out = torch.empty((full.shape[0] // n,) + full.shape[1:], dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, full, group=group)
    return out.movedim(0, -1)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (a (..., k), b (k, n)) with a float32 (or wider) result and
    no rounding before it: a bf16 pair's products are exact in float32, so
    the CPU's float32 product of the widened inputs and the card's bf16
    product with a float32 output (`out_dtype`, also on the dry run's meta
    tensors) compute the same sums."""
    wide = torch.promote_types(a.dtype, torch.float32)
    if a.dtype == wide or a.dtype != b.dtype or a.device.type == "cpu":
        return a.to(wide) @ b.to(wide)
    out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=wide)
    return out.reshape(*a.shape[:-1], b.shape[-1])


def _mm_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T b over every leading dim of a and b (..., i) x (..., j) -> (i, j):
    a weight's gradient from its input and its output's gradient."""
    return a.reshape(-1, a.shape[-1]).t() @ b.reshape(-1, b.shape[-1])


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _CopyToF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # float() of a float32 g is g itself, which the engine may share.
        return all_reduce_(g.to(torch.float32, copy=True), ctx.group).to(g.dtype), None


class _ColParallel(torch.autograd.Function):
    """[x @ w_i + b_i] for column blocks (d, n_i / m) of projections that
    read one x replicated over `model`; x's gradient is this rank's
    partial products sum_i g_i w_i^T, summed in float32 and rounded to x's
    dtype, then summed over `model` in that dtype (megatron's bf16
    all-reduce: half the bytes of a float32 one); each w_i's and b_i's
    gradient this rank's block's."""

    @staticmethod
    def forward(ctx, x, group, *wb):
        ctx.group, ctx.has_b = group, [b is not None for b in wb[1::2]]
        ws = wb[0::2]
        ctx.save_for_backward(x, *ws)
        outs = []
        for w, b in zip(ws, wb[1::2]):
            y = x @ w
            outs.append(y if b is None else y + b)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        x, *ws = ctx.saved_tensors
        dx = None
        grads = []
        for g, w, has_b in zip(gs, ws, ctx.has_b):
            part = _mm_f32(g, w.t())
            dx = part if dx is None else dx + part
            grads += [_mm_t(x, g).to(w.dtype), g.sum_to_size(g.shape[-1:]) if has_b else None]
        return (all_reduce_(dx.to(x.dtype), ctx.group), None, *grads)


class _RowParallel(torch.autograd.Function):
    """x @ w for this rank's row block w (k / m, n) and x its k / m
    columns: the float32 partial products summed over `model`, rounded
    once.  The gradients are local: x's g w^T, w's x^T g."""

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        return all_reduce_(_mm_f32(x, w), group).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return g @ w.t(), _mm_t(x, g).to(w.dtype), None


class _RowScatter(torch.autograd.Function):
    """`_RowParallel`'s sum, reduce-scattered: this rank's block of the
    output's columns (n / m).  Backward: the output's gradient all-gathered
    over its columns, then local."""

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        ctx.group = group
        return _reduce_scatter_last(_mm_f32(x, w), group).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = _gather(g, ctx.group, g.ndim - 1)
        return g @ w.t(), _mm_t(x, g).to(w.dtype), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return all_reduce_(x.contiguous().clone(), group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group, ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def copy_to_f32(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToF32.apply(x, group)


def col_parallel(x: torch.Tensor, wbs: list, group) -> tuple:
    """(x @ w + b, ...) for each (w, b) of `wbs` (b None: no bias), w this
    rank's column block (`_ColParallel`)."""
    return _ColParallel.apply(x, group, *(t for wb in wbs for t in wb))


def row_parallel(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    return _RowParallel.apply(x, w, group)


def row_scatter(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    return _RowScatter.apply(x, w, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def mean_from(x: torch.Tensor, group) -> torch.Tensor:
    return _MeanFrom.apply(x, group)


def split_to(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _SplitTo.apply(x, group, dim)


def gather_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _GatherFrom.apply(x, group, dim)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduce.apply(x, group)
