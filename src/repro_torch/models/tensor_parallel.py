"""The model's dense layers partitioned over the `model` axis, as the
sharding rules lay their weights out (`sharding.partition`) and GSPMD
partitions the JAX package's: megatron's column- and row-parallel
products.

A fan-out projection (wq / wk / wv, the FFN's gate / up, RWKV's wr ... ck,
cr, Mamba's in_proj and dt_proj, MLA's q_up / kv_up) holds a column
block (d, n / m): it reads the residual stream, replicated over `model`,
and gives this rank's n / m output columns (`cols`; one float32
all-reduce of the input's gradient in the backward pass).  A fan-in
projection (wo, down, cv, out_proj) holds a row block (n / m, d): it reads
this rank's n / m columns and its partial products are summed over
`model` in float32 (`row`).  A leaf the rules replicate but a layer reads
per rank (RWKV's w0, u, ln_x; Mamba's x_proj) is sliced to this rank's
heads or channels (`local`: its gradient all-gathered, so every rank's is
whole).  Activations move (`gather_cols`, `split_cols`), weights never.

`TP` is the `model` axis as a layer sees it; None off a mesh and on a
`model` axis of one rank, where every helper is the plain single-device
op, so that path computes the unmeshed model's bits.  A layer given a
leaf that is not its rules' block refuses with the leaf's name (`block`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from ..sharding import comm
from ..sharding.ctx import meshed
from ..sharding.partition import MODEL_AXIS
from .layers import dense, swiglu as swiglu_whole

__all__ = ["TP", "model_tp", "at", "block", "col", "cols", "row", "row_scatter", "gather_cols",
           "split_cols", "local", "swiglu"]


@dataclasses.dataclass(frozen=True)
class TP:
    """The `model` axis of a meshed layer: its process group, size and this
    rank's index; `where` is the layer's path in the parameter tree (for
    errors)."""

    group: Any
    size: int
    rank: int
    where: tuple = ()


def model_tp(ctx) -> TP | None:
    """The `model` axis of `ctx` where it partitions the layers (a mesh
    whose `model` axis has more than one rank), else None."""
    if not meshed(ctx) or ctx.size(MODEL_AXIS) == 1:
        return None
    return TP(ctx.group(MODEL_AXIS), ctx.size(MODEL_AXIS), ctx.rank(MODEL_AXIS))


def at(tp: TP | None, *keys) -> TP | None:
    """`tp` for the sublayer at `keys` below its path."""
    return None if tp is None else dataclasses.replace(tp, where=tp.where + keys)


def block(tp: TP, t: torch.Tensor, dim: int, whole: int, name: str) -> None:
    """Refuse unless `t` is this rank's block of `whole` along `dim`."""
    if t.shape[dim] * tp.size != whole:
        leaf = ".".join(str(k) for k in tp.where + (name,))
        raise ValueError(
            f"{leaf}: a {tuple(t.shape)} leaf is not a block of {whole} along dim {dim} over "
            f"model={tp.size}; the tensor-parallel layer computes with its rules' block "
            "(`sharding.params.shard_tree`) and gathers no weight")


def col(tp: TP | None, p, x: torch.Tensor) -> torch.Tensor:
    """dense(p, x): on a mesh p a column block (`cols` of one)."""
    return cols(tp, [p], x)[0]


def cols(tp: TP | None, ps: list, x: torch.Tensor) -> list:
    """[dense(p, x) for p in ps]: on a mesh each p a column block, the
    outputs this rank's columns (`comm.col_parallel`)."""
    if tp is None:
        return [dense(p, x) for p in ps]
    return list(comm.col_parallel(x, [(p["w"], p.get("b")) for p in ps], tp.group))


def row(tp: TP | None, p, x: torch.Tensor) -> torch.Tensor:
    """dense(p, x): on a mesh p["w"] a row block and x this rank's columns,
    the partial products summed over `model` (`comm.row_parallel`), then
    the replicated bias."""
    if tp is None:
        return dense(p, x)
    y = comm.row_parallel(x, p["w"], tp.group)
    return y + p["b"] if "b" in p else y


def row_scatter(tp: TP | None, p, x: torch.Tensor) -> torch.Tensor:
    """dense(p, x) for a p with no bias: on a mesh p["w"] a row block and x
    this rank's columns, the partial products' float32 sum reduce-scattered
    onto this rank's block of the output's columns (`comm.row_scatter`)."""
    if tp is None:
        return dense(p, x)
    return comm.row_scatter(x, p["w"], tp.group)


def gather_cols(tp: TP | None, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The ranks' blocks of t along `dim` (default its last), whole (an
    activation)."""
    return t if tp is None else comm.gather_from(t, tp.group, dim % t.ndim)


def split_cols(tp: TP | None, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's block of t along `dim` (default its last), t replicated
    over `model`."""
    return t if tp is None else comm.split_to(t, tp.group, dim % t.ndim)


def local(tp: TP | None, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's block of a replicated leaf along `dim` (its gradient
    all-gathered, so every rank holds the whole leaf's)."""
    return t if tp is None else comm.split_to(t, tp.group, dim)


def swiglu(tp: TP | None, p, x: torch.Tensor, ff: int) -> torch.Tensor:
    """The SwiGLU FFN (`layers.swiglu`) of hidden width `ff`: on a mesh gate
    and up column blocks (d, ff / m), down a row block (ff / m, d), one
    float32 sum of the output over `model`."""
    if tp is None:
        return swiglu_whole(p, x)
    for name, dim in (("gate", 1), ("up", 1), ("down", 0)):
        block(tp, p[name]["w"], dim, ff, name)
    gate, up = cols(tp, [p["gate"], p["up"]], x)
    return row(tp, p["down"], F.silu(gate) * up)
