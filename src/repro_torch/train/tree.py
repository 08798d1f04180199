"""Parameter trees of the model zoo, and the JAX package's view of them.

A port tree is nested dicts (and tuples, e.g. `AdamState`) of tensors in
which a per-layer group is a list of per-layer dicts:

    params["s{si}_l{li}"] = [layer_0, layer_1, ...]      (repeats entries)

where the JAX package stacks the group's leaves on a leading `repeats`
axis (`models/transformer.py`).  `tree_map` / `tree_leaves` walk the port
tree as it is, in insertion order.  `jax_leaves` / `map_jax_leaves` walk it
as the JAX tree: dict keys sorted (jax.tree_util's order), NamedTuple
fields by name, and a per-layer list as ONE leaf per path of its layers
(the stacked leaf), handed over as the list of that leaf in every layer.
This is what an optimizer that is not elementwise (Adafactor's factored
moments and update clip, the global norm's summation order) and the
checkpoint's file layout need.  Lists occur in port trees only as
per-layer groups.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["tree_map", "tree_leaves", "tree_unflatten", "tree_slots", "jax_leaves",
           "map_jax_leaves", "stacked"]

# A JAX-layout leaf: a tensor, or (a per-layer group) one tensor per layer.
Leaf = Any


def tree_map(fn: Callable, tree, *rest):
    """fn applied leafwise over `tree` and trees of the same structure,
    in `tree`'s insertion order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves) -> Any:
    """The tree of `like`'s structure whose `tree_leaves` are `leaves`."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_slots(tree) -> list[tuple[Any, Any]]:
    """(container, key) of every leaf of a tree of dicts and lists, in
    `tree_leaves`' order: container[key] = x puts x in the leaf's place."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        raise TypeError(f"tree_slots: a leaf's slot is in a dict or a list, not a {type(tree)}")
    return [slot for k, v in items
            for slot in (tree_slots(v) if isinstance(v, (dict, list)) else [(tree, k)])]


def _fields(tree: tuple):
    return getattr(tree, "_fields", None) or tuple(range(len(tree)))


def jax_leaves(tree, prefix: tuple[str, ...] = ()) -> list[tuple[tuple[str, ...], Leaf]]:
    """(path, leaf) for every leaf of the JAX layout, in jax.tree_util's
    order; a per-layer group's leaf is the list of its layers' tensors."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in jax_leaves(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple):
        return [item for name, v in zip(_fields(tree), tree)
                for item in jax_leaves(v, prefix + (str(name),))]
    if isinstance(tree, list):
        layers = [jax_leaves(layer, prefix) for layer in tree]
        return [(path, [layer[j][1] for layer in layers])
                for j, (path, _) in enumerate(layers[0])]
    return [(prefix, tree)]


def _rebuild(layer, prefix: tuple[str, ...], get: Callable):
    """A layer's dict structure with the leaf at each path from get(path)."""
    if isinstance(layer, dict):
        return {k: _rebuild(v, prefix + (str(k),), get) for k, v in layer.items()}
    return get(prefix)


def map_jax_leaves(fn: Callable[[tuple[str, ...], Leaf], Any], tree, *, stack: bool = False,
                   prefix: tuple[str, ...] = ()):
    """`tree` with each JAX-layout leaf replaced by fn(path, leaf).  For a
    per-layer group fn returns one tensor per layer, which go back into the
    layers' dicts; with `stack=True` it returns one tensor, and the group
    becomes a dict shaped like one layer, as in the JAX tree."""
    if isinstance(tree, dict):
        return {k: map_jax_leaves(fn, v, stack=stack, prefix=prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [map_jax_leaves(fn, v, stack=stack, prefix=prefix + (str(n),))
                for n, v in zip(_fields(tree), tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    if isinstance(tree, list):
        new = {path: fn(path, leaf) for path, leaf in jax_leaves(tree, prefix)}
        if stack:
            return _rebuild(tree[0], prefix, new.__getitem__)
        return [_rebuild(layer, prefix, lambda p, i=i: new[p][i]) for i, layer in enumerate(tree)]
    return fn(prefix, tree)


def stacked(leaf: Leaf) -> torch.Tensor:
    """A JAX-layout leaf as the JAX tree holds it: a group's layers stacked
    on a new leading axis."""
    return torch.stack(leaf) if isinstance(leaf, list) else leaf
