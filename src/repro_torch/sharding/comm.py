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
                                     that every shard's loss reads.

`all_reduce_` (sum), `all_reduce_max_` and `all_reduce_min_` reduce in
place with no gradient: a decode step's softmax statistics and greedy
token, the max a log-softmax subtracts (its gradient cancels).

Every collective runs as called, whatever the group's size, so a world
of one takes the same path as a mesh of many.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["copy_to", "reduce_from", "mean_from", "split_to", "gather_from", "all_reduce",
           "all_reduce_", "all_reduce_max_", "all_reduce_min_", "gather_"]


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


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


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
