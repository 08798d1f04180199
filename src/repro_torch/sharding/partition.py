"""Parameter / optimizer-state / cache / batch sharding rules of the
production mesh (PyTorch copy of the JAX package's `sharding/partition.py`).

The rules read nothing of a mesh but its shape ({axis name: size}), so
they hold at meshes no machine here has: (data=16, model=16) and (pod=2,
data=16, model=16).  A spec is a tuple with one entry per tensor dim: None
(replicated), an axis name, or a tuple of axis names (the data-parallel
axes of a batch dim).  Logical layout (megatron-style):

  * fan-out projections (wq/wk/wv, ffn gate/up, embed vocab, lm_head ...)
    shard their OUTPUT dim on `model`; fan-in projections (wo, ffn down)
    their INPUT dim;
  * MoE expert banks shard the leading expert dim on `model` (expert
    parallelism, `models.moe`); shared experts are replicated;
  * everything small (norms, biases, routers, loras) is replicated;
  * a dim is sharded only when the axis size divides it (whisper's 51865
    vocabulary stays replicated);
  * a per-layer group's leading `repeats` dim is never sharded.

The port keeps a per-layer group as a list of per-layer dicts where the
JAX package stacks it on a leading `repeats` axis (`models.transformer`).
Each rule is applied to the JAX layout — the group's leaf at its stacked
shape, its path without the layer index — and a layer's spec is the
stacked spec without its leading dim, so the port's specs are the JAX
package's by construction.

The tree functions return {path: spec} over the leaves of a port tree,
`leaves_with_path`'s paths: dict keys, list indices (ints) and NamedTuple
field names.  `placements` turns a spec into `DTensor` placements on a
`DeviceMesh`.
"""
from __future__ import annotations

from typing import Any, Iterator

import numpy as np

__all__ = ["param_spec", "param_shardings", "opt_state_shardings", "cache_shardings",
           "cache_model_dim", "batch_shardings", "leaves_with_path", "map_with_path", "placements",
           "MODEL_AXIS"]

MODEL_AXIS = "model"

# (match keys in path, base spec builder). First match wins; specs are for
# the *unstacked* trailing dims of the leaf.
_FANOUT_2D = ("wq", "wk", "wv", "gate", "up", "fc", "q_up", "kv_up",
              "wr", "wg", "ck", "cr", "in_proj", "dt_proj", "lm_head", "mtp_head",
              "w_lora_b")
_FANIN_2D = ("wo", "down", "proj", "out_proj", "cv")
_REPLICATED = ("router", "q_down", "kv_down", "w_lora_a", "x_proj")


def _shape_of(mesh) -> dict:
    from ..launch.mesh import mesh_shape
    return mesh_shape(mesh)


def param_spec(path, shape, mesh) -> tuple:
    """The spec of one parameter leaf of `shape` at `path` (its names, as
    the JAX tree has them: a stacked group's leaf without a layer index)
    on a mesh of this shape: the base spec of its trailing dims, None-padded
    for stacked dims."""
    names = [str(k) for k in path]
    shape = tuple(shape)
    ndim = len(shape)
    m = _shape_of(mesh)[MODEL_AXIS]

    def div(n: int) -> bool:
        return n % m == 0

    def pad(base: tuple) -> tuple:
        return (None,) * (ndim - len(base)) + tuple(base)

    if "embed" in names:
        if ndim >= 2 and div(shape[-2]):
            return pad((MODEL_AXIS, None))
        return pad((None, None))
    # MoE expert banks: (E, d, ff) / (E, ff, d).
    if names[-1] in ("gate", "up", "down") and ndim >= 3 and "shared" not in names:
        if div(shape[-3]):
            return pad((MODEL_AXIS, None, None))
        return pad((None, None, None))
    # Shared experts are replicated (the JAX package's §Perf iteration 3).
    if "shared" in names:
        return (None,) * ndim

    parent = names[-2] if len(names) >= 2 else ""
    leafname = names[-1]
    key = parent if leafname in ("w", "b") else leafname
    if key in _REPLICATED:
        return (None,) * ndim
    if key in _FANOUT_2D:
        ax = MODEL_AXIS if div(shape[-1]) else None
        if leafname == "b" or ndim < 2:
            return pad((ax,))
        return pad((None, ax))
    if key in _FANIN_2D:
        if leafname == "b" or ndim < 2:
            return pad((None,))
        return pad((MODEL_AXIS if div(shape[-2]) else None, None))
    if key == "conv_w":                       # (kw, d_inner)
        return pad((None, MODEL_AXIS if div(shape[-1]) else None))
    if key == "a_log":                        # (d_inner, N)
        return pad((MODEL_AXIS if div(shape[-2]) else None, None))
    if key in ("dt_bias", "d_skip", "conv_b"):
        return pad((MODEL_AXIS if div(shape[-1]) else None,))
    # norms, mu, u, w0, scalars, everything else: replicated.
    return (None,) * ndim


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _walk(tree, path: tuple, jpath: tuple, stack: tuple) -> Iterator:
    """(path, JAX-layout path, stacked dims, leaf) of every leaf: `stack`
    holds the length of each per-layer group the leaf sits in."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,), jpath + (str(k),), stack)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,), jpath, stack + (len(tree),))
    elif isinstance(tree, tuple):
        for name, v in zip(getattr(tree, "_fields", None) or range(len(tree)), tree):
            yield from _walk(v, path + (name,), jpath + (str(name),), stack)
    else:
        yield path, jpath, stack, tree


def leaves_with_path(tree) -> list[tuple[tuple, Any]]:
    """(path, leaf) of every leaf of a port tree (dicts, per-layer lists,
    NamedTuples and tuples), in its own order."""
    return [(path, leaf) for path, _, _, leaf in _walk(tree, (), (), ())]


def map_with_path(fn, tree, path: tuple = ()):
    """`tree` (dicts, per-layer lists, NamedTuples, tuples) with each leaf
    replaced by fn(path, leaf), `leaves_with_path`'s paths."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None)
        vals = [map_with_path(fn, v, path + (n,))
                for n, v in zip(names or range(len(tree)), tree)]
        return type(tree)(*vals) if names else tuple(vals)
    return fn(path, tree)


def _stacked_shape(stack: tuple, leaf) -> tuple:
    return tuple(stack) + tuple(leaf.shape)


def param_shardings(params, mesh) -> dict:
    """{path: spec} for every parameter leaf (a layer's leaf: its group's
    stacked spec without the leading dim)."""
    return {path: param_spec(jpath, _stacked_shape(stack, leaf), mesh)[len(stack):]
            for path, jpath, stack, leaf in _walk(params, (), (), ())}


def _stacked_param_specs(params, mesh) -> dict:
    return {jpath: param_spec(jpath, _stacked_shape(stack, leaf), mesh)
            for _, jpath, stack, leaf in _walk(params, (), (), ())}


def opt_state_shardings(opt_state, params, mesh) -> dict:
    """{path: spec} for every optimizer-state leaf, mirrored from the
    parameters' specs as the JAX package mirrors them: a leaf at a path
    whose suffix is a parameter's path takes its spec when the ranks agree,
    the spec without its last dim when the leaf has one dim fewer (a
    factored moment), else (the fallback) the parameter's spec as it is;
    anything else (step counts) is replicated.  Adafactor's moments are
    kept stacked (`train.optimizer`), so they match the stacked specs."""
    flat = _stacked_param_specs(params, mesh)

    def match(jpath: tuple, ndim: int) -> tuple:
        for start in range(len(jpath)):
            pspec = flat.get(jpath[start:])
            if pspec is not None:
                if len(pspec) == ndim:
                    return pspec
                if len(pspec) == ndim + 1:
                    return pspec[:-1]
        for start in range(len(jpath)):
            if jpath[start:] in flat:
                return flat[jpath[start:]]
        return (None,) * ndim

    return {path: match(jpath, len(stack) + leaf.ndim)[len(stack):]
            for path, jpath, stack, leaf in _walk(opt_state, (), (), ())}


def _dp_total(m: dict, dp: tuple) -> int:
    return int(np.prod([m[a] for a in dp]))


def _cache_spec(name: str, shape: tuple, dp: tuple, dp_total: int, mp: int) -> tuple:
    """The spec of one cache leaf named `name` at its stacked `shape`."""
    nd = len(shape)

    def ax_b(i):
        return dp if shape[i] % dp_total == 0 else None

    def ax_m(i):
        return MODEL_AXIS if shape[i] % mp == 0 else None

    if name in ("k", "v"):                 # (R, B, C, Hkv, dh)
        return (None, ax_b(1), ax_m(2), None, None)
    if name in ("c_kv", "k_pe"):           # (R, B, C, r)
        return (None, ax_b(1), ax_m(2), None)
    if name == "wkv":                      # (R, B, H, hs, hs)
        return (None, ax_b(1), ax_m(2), None, None)
    if name == "ssm":                      # (R, B, di, N)
        return (None, ax_b(1), ax_m(2), None)
    if name == "conv":                     # (R, B, kw - 1, di)
        return (None, ax_b(1), None, ax_m(3))
    if name in ("prev_tok", "cm_prev"):    # (R, B, d)
        return (None, ax_b(1), None)
    if name == "enc_out":                  # (B, Se, d), unstacked
        return (dp if shape[0] % dp_total == 0 else None, None, None)
    return (None,) * nd


def cache_shardings(cache, mesh, dp_axes) -> dict:
    """{path: spec} for a decode cache (the JAX stage-stacked layout): the
    cache-length dim on `model` (robust for any kv-head count), batch on
    the data axes, recurrent states on `model` along heads / channels."""
    m = _shape_of(mesh)
    dp = tuple(dp_axes)
    dp_total, mp = _dp_total(m, dp), m[MODEL_AXIS]
    return {path: _cache_spec(str(path[-1]), tuple(leaf.shape), dp, dp_total, mp)
            for path, leaf in leaves_with_path(cache)}


def cache_model_dim(name: str, shape: tuple, mp: int) -> int | None:
    """The dim of one layer's cache leaf `name` (its shape without the
    stacked `repeats` dim) that `cache_shardings` puts on a `model` axis
    of size `mp`, or None where it keeps the leaf whole over `model`."""
    spec = _cache_spec(name, (1,) + tuple(shape), (), 1, mp)[1:]
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def batch_shardings(batch, mesh, dp_axes) -> dict:
    """{path: spec} for an input batch: the batch dim on the data axes
    (replicated when they do not divide it, e.g. long_500k's batch of 1)."""
    m = _shape_of(mesh)
    dp = tuple(dp_axes)
    dp_total = _dp_total(m, dp)

    def spec(shape: tuple) -> tuple:
        if not shape:
            return ()
        return (dp if shape[0] % dp_total == 0 else None,) + (None,) * (len(shape) - 1)

    return {path: spec(tuple(leaf.shape)) for path, leaf in leaves_with_path(batch)}


def placements(spec: tuple, mesh) -> list:
    """A spec as `DTensor` placements on a `DeviceMesh`: for each mesh dim,
    Shard(d) of the tensor dim d that names it, else Replicate()."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec)
                if entry == axis or (isinstance(entry, tuple) and axis in entry)]
        if len(dims) > 1:
            raise ValueError(f"placements: mesh axis {axis!r} shards dims {dims} of {spec}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return out
