"""Checkpointing: tree <-> .npz with path-keyed arrays (PyTorch copy of the
JAX package's `checkpoint/ckpt.py`), in the JAX package's file layout, so a
file written by either package restores into the other:

  * one array per leaf of the JAX tree, keyed by its path joined with "|"
    (dict keys, NamedTuple field names such as `AdamState`'s
    "count|mu|nu", tuple indices);
  * a per-layer group (`s{si}_l{li}`, a list of per-layer dicts in the
    port) as the JAX tree's stacked leaf, (repeats, ...), unstacked into
    the layers on restore (`train.tree.jax_leaves`);
  * bf16 as its uint16 bits under the key "__bf16__" + path (npz has no
    bfloat16), and the step as "__step__".

Works for params and optimizer states.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from ..train.tree import jax_leaves, map_jax_leaves, stacked

__all__ = ["save_checkpoint", "restore_checkpoint"]

_SEP = "|"
_BF16_TAG = "__bf16__"


def save_checkpoint(path: str, tree: Any, *, step: int | None = None) -> None:
    arrays = {}
    for p, leaf in jax_leaves(tree):
        key = _SEP.join(p)
        t = stacked(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            arrays[_BF16_TAG + key] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arrays[key] = t.numpy()
    if step is not None:
        arrays["__step__"] = np.asarray(step)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def restore_checkpoint(path: str, like: Any) -> tuple[Any, int | None]:
    """Restore into the structure of `like` (shapes must match), each leaf
    on the device of `like`'s leaf, in the file's dtype."""
    with np.load(path) as data:
        step = int(data["__step__"]) if "__step__" in data else None

        def fill(p, leaf):
            key = _SEP.join(p)
            if _BF16_TAG + key in data:
                t = torch.from_numpy(data[_BF16_TAG + key].view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(data[key])
            members = leaf if isinstance(leaf, list) else [leaf]
            want = ((len(members),) if isinstance(leaf, list) else ()) + tuple(members[0].shape)
            if tuple(t.shape) != want:
                raise ValueError(f"shape mismatch at {key}: {tuple(t.shape)} vs {want}")
            if isinstance(leaf, list):
                return [x.to(m.device) for x, m in zip(t.unbind(0), members)]
            return t.to(leaf.device)

        return map_jax_leaves(fill, like), step
