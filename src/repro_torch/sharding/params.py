"""The model's parameters on a mesh: this rank's blocks.

Storage follows the rules of `partition.py` ({path: spec}, which the model
computes from its shapes: `models.transformer.param_specs`): `shard_tree`
keeps, of each leaf, this rank's block along every dim its spec names a
mesh axis for (no communication: every rank holds the whole tree when it
starts), each block in a storage of its own, so the whole leaf can be
freed.  The model computes with the blocks as they are held
(`models.tensor_parallel`): the fan-out projections' column blocks and the
fan-in projections' row blocks are megatron's column- and row-parallel
dense layers, so a layer moves activations over `model` and never a
weight; the MoE's expert banks are this rank's experts (expert
parallelism, `models.moe`), and the vocab-sharded `embed`, `lm_head` and
`mtp_head` this rank's vocab block (`models.transformer`).

One block is not the rule's contiguous one: a Mamba layer's `in_proj` (d,
2 di) computes [xi | z], two halves that the layer splits, and its
channel-parallel scan needs channel block r of both.  So rank r holds
[xi_r | z_r], the r-th block of each half side by side (`PAIRED`,
`model_block`): the bytes of the rule's block, in the order the layer
reads them.  `join_blocks` is the inverse.
"""
from __future__ import annotations

import torch

from .partition import MODEL_AXIS, map_with_path

__all__ = ["shard_tree", "is_expert_bank", "block_of", "paired", "model_block", "join_blocks"]

# The leaves whose `model` block is paired ([first-half block | second-half
# block]): (the layer's key, the leaf's name).
PAIRED = (("in_proj", "w"),)


def is_expert_bank(path: tuple) -> bool:
    """A MoE layer's (E, d|ff, ff|d) expert bank (not a shared expert)."""
    return "moe" in path and path[-1] in ("gate", "up", "down")


def _axes(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def paired(path: tuple) -> bool:
    """Whether the leaf at `path` (a parameter's path, or its JAX-layout
    path: names without layer indices) holds a paired `model` block."""
    names = tuple(str(k) for k in path if not isinstance(k, int))
    return names[-2:] in PAIRED


def model_block(t: torch.Tensor, dim: int, n: int, r: int, pair: bool = False) -> torch.Tensor:
    """Block r of n of `t` along `dim` (a view); with `pair`, block r of
    each half of the dim, side by side (a new tensor)."""
    if not pair:
        return t.chunk(n, dim=dim)[r]
    return torch.cat([h.chunk(n, dim=dim)[r] for h in t.chunk(2, dim=dim)], dim=dim)


def join_blocks(blocks: list, dim: int, pair: bool = False) -> torch.Tensor:
    """The whole tensor from its n `model_block`s along `dim`, in rank
    order: their concatenation, or with `pair` each half's."""
    if not pair:
        return torch.cat(blocks, dim=dim)
    halves = [b.chunk(2, dim=dim) for b in blocks]
    return torch.cat([h[0] for h in halves] + [h[1] for h in halves], dim=dim)


def block_of(t: torch.Tensor, spec: tuple, mesh, path: tuple = ()) -> torch.Tensor:
    """This rank's block of `t` along every dim `spec` names mesh axes for
    (a tuple of axes: the first one outermost; on `model` the paired block
    where `path` names a `PAIRED` leaf), in a storage of its own where it
    is a part of `t` (a dim-0 block of a contiguous tensor is a view into
    the whole storage); `t` itself where the spec shards nothing."""
    out = t
    for dim, entry in enumerate(spec):
        for axis in _axes(entry):
            n = mesh.size(mesh.mesh_dim_names.index(axis))
            out = model_block(out, dim, n, mesh.get_local_rank(axis),
                              axis == MODEL_AXIS and paired(path))
    if out is t:
        return t
    out = out.contiguous()
    if out.untyped_storage().nbytes() != out.nbytes:
        out = out.clone()
    return out


def shard_tree(tree, specs: dict, mesh):
    """This rank's block of every leaf of `tree` ({path: spec} `specs`),
    each block its own storage (`block_of`)."""
    return map_with_path(lambda path, t: block_of(t, specs[path], mesh, path), tree)
