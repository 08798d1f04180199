"""The model's parameters on a mesh: this rank's blocks, and the whole
tensors its per-rank code computes with.

Storage follows the rules of `partition.py` ({path: spec}, which the model
computes from its shapes: `models.transformer.param_specs`): `shard_tree`
keeps, of each leaf, this rank's block along every dim its spec names a
mesh axis for (no communication: every rank holds the whole tree when it
starts), each block in a storage of its own, so the whole leaf can be
freed.  The meshed model gathers a dense leaf sharded over `model` where it
uses it, one sublayer at a time (`gather_params` on that sublayer's
subtree, inside the remat boundary: the backward pass gathers again and
saves no whole weight, ZeRO-3's order); `comm.gather_from`'s backward
keeps this rank's block of the gradient.  The MoE's expert banks stay this
rank's experts (expert parallelism, `models.moe`), and the vocab-sharded
`lm_head` / `mtp_head` stay this rank's vocab block (vocab-parallel
logits, `models.transformer`).  So the dense layers run replicated over
`model` on weights stored sharded (ZeRO-3's layout along `model`); the
experts, the logits and, with attn_shard="explicit", attention are
partitioned.
"""
from __future__ import annotations

import torch

from . import comm
from .partition import map_with_path

__all__ = ["shard_tree", "gather_params", "is_expert_bank", "block_of"]


def is_expert_bank(path: tuple) -> bool:
    """A MoE layer's (E, d|ff, ff|d) expert bank (not a shared expert)."""
    return "moe" in path and path[-1] in ("gate", "up", "down")


def _axes(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def block_of(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of `t` along every dim `spec` names mesh axes for
    (a tuple of axes: the first one outermost), in a storage of its own
    where it is a part of `t` (a dim-0 block of a contiguous tensor is a
    view into the whole storage); `t` itself where the spec shards
    nothing."""
    out = t
    for dim, entry in enumerate(spec):
        for axis in _axes(entry):
            n = mesh.size(mesh.mesh_dim_names.index(axis))
            out = out.chunk(n, dim=dim)[mesh.get_local_rank(axis)]
    if out is t:
        return t
    out = out.contiguous()
    if out.untyped_storage().nbytes() != out.nbytes:
        out = out.clone()
    return out


def shard_tree(tree, specs: dict, mesh):
    """This rank's block of every leaf of `tree` ({path: spec} `specs`),
    each block its own storage (`block_of`)."""
    return map_with_path(lambda path, t: block_of(t, specs[path], mesh), tree)


def gather_params(params, specs: dict, ctx, prefix: tuple = ()):
    """The whole tensors of a (sub)tree of this rank's blocks: each dense
    leaf all-gathered over every axis its spec names (the inverse of
    `shard_tree`), expert banks as held.  `prefix` is the subtree's path in
    the whole tree, which `specs` is keyed by (e.g. ("s0_l0", 3) for layer
    3 of a group)."""
    def whole(path, leaf):
        if is_expert_bank(path):
            return leaf
        for dim in reversed(range(len(specs[path]))):
            for axis in reversed(_axes(specs[path][dim])):
                leaf = comm.gather_from(leaf, ctx.group(axis), dim)
        return leaf

    return map_with_path(whole, params, prefix)
