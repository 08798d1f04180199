"""The model's parameters on a mesh: this rank's blocks, and the whole
tensors its per-rank code computes with.

Storage follows the rules of `partition.py` ({path: spec}, which the model
computes from its shapes: `models.transformer.param_specs`): `shard_tree`
keeps, of each leaf, this rank's block along every dim its spec names a
mesh axis for (no communication: every rank holds the whole tree when it
starts).  The meshed forward (`models.transformer.forward` with a
`ShardCtx`) calls `gather_params` once: each dense leaf sharded over
`model` is all-gathered whole (`comm.gather_from`, whose backward keeps
this rank's block of the gradient), while the MoE's expert banks stay
this rank's experts (expert parallelism, `models.moe`).  So the dense
layers run replicated over `model` on weights stored sharded (ZeRO-3's
layout along `model`), the experts and, with attn_shard="explicit",
attention are partitioned.
"""
from __future__ import annotations

import torch

from . import comm
from .partition import map_with_path

__all__ = ["shard_tree", "gather_params", "is_expert_bank"]


def is_expert_bank(path: tuple) -> bool:
    """A MoE layer's (E, d|ff, ff|d) expert bank (not a shared expert)."""
    return "moe" in path and path[-1] in ("gate", "up", "down")


def _axes(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _block(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    for dim, entry in enumerate(spec):
        for axis in _axes(entry):
            n = mesh.size(mesh.mesh_dim_names.index(axis))
            t = t.chunk(n, dim=dim)[mesh.get_local_rank(axis)]
    return t.contiguous()


def shard_tree(tree, specs: dict, mesh):
    """This rank's block of every leaf of `tree` ({path: spec} `specs`)."""
    return map_with_path(lambda path, t: _block(t, specs[path], mesh), tree)


def gather_params(params, specs: dict, ctx):
    """The parameters the meshed forward computes with: dense leaves whole
    (all-gathered over each axis their spec names, the inverse of
    `shard_tree`), expert banks as held."""
    def whole(path, leaf):
        if is_expert_bank(path):
            return leaf
        for dim in reversed(range(len(specs[path]))):
            for axis in reversed(_axes(specs[path][dim])):
                leaf = comm.gather_from(leaf, ctx.group(axis), dim)
        return leaf

    return map_with_path(whole, params)
