"""Functional optimizers over parameter trees (PyTorch copy of the JAX
package's `train/optimizer.py`).

The JAX package's GradientTransformation-style API, kept:

    opt = adam(1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

with the same arithmetic.  A tree is a flat dict of tensors (the paper's
models, `models/small.py`) or a model-zoo tree (`train/tree.py`: nested
dicts with per-layer lists).  sgd's update is -lr * g; adam and adamw keep
float32 moments and adam's bias corrections 1 - b ** count in float32;
momentum, adamw and adafactor are the model zoo's.  sgd, momentum, adam
and adamw are elementwise, so the per-layer lists change nothing.
Adafactor's factored moments and its update clip are not: it takes each
per-layer group as the JAX package's stacked leaf (`tree.jax_leaves`), so
a per-layer 1-D leaf is a 2-D (repeats, D) leaf and is factored, and the
clip's RMS runs over all the group's layers, as in the JAX package.  Its
row and column moments are kept in the JAX tree's stacked layout.

The elementwise four also update in place (`Optimizer.donate`), the
counterpart of the JAX package's donated train step: `opt.donate(state,
params)` returns the new state and one update per parameter leaf, which
takes that leaf's gradient and writes the new moments and the new
parameter into their own storage.  It computes the same expressions in the
same order as `update` and `apply_updates`, so its results are their bits.
Adafactor, whose clip spans a group's layers, has none.

On a mesh (per-rank code over this rank's parameter blocks,
`sharding.params.shard_tree`) the elementwise four run on the blocks as
they are.  Adafactor's statistics span whole rows and columns, so it has a
meshed form (`Optimizer.sharded`, `adafactor_sharded`): the state in the
layout `sharding.partition.opt_state_shardings` gives it (the JAX
package's mirroring rule: a factored moment takes its parameter's spec
without the last dim), the row and column means and the update's RMS
summed over `model`, so the update is the unsharded one up to summation
order.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import torch

from ..sharding import comm
from ..sharding.params import join_blocks, model_block, paired
from .tree import jax_leaves, map_jax_leaves, stacked, tree_leaves, tree_map, tree_slots

__all__ = [
    "Optimizer",
    "AdamState",
    "AdafactorState",
    "apply_updates",
    "sgd",
    "momentum",
    "adam",
    "adamw",
    "adafactor",
    "adafactor_sharded",
    "clip_by_global_norm",
    "chain",
    "global_norm",
    "make_optimizer",
]


# One parameter leaf's in-place update: takes its gradient, returns nothing.
LeafUpdate = Callable[[torch.Tensor], None]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]  # (grads, state, params)
    # (state, params) -> (new state, one LeafUpdate per leaf of tree_leaves(params));
    # None where the update is not elementwise (Adafactor, the clip).
    donate: Callable[[Any, Any], tuple[Any, list[LeafUpdate]]] | None = None
    # (param specs {path: spec}, ShardCtx) -> the optimizer over this rank's
    # parameter blocks with its state in the sharding rules' layout; None
    # where the update is elementwise and runs on blocks as it is.
    sharded: Callable[[dict, Any], "Optimizer"] | None = None


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in float32, summed leaf by
    leaf in the JAX tree's order (a per-layer group layer by layer)."""
    total = None
    for _, leaf in jax_leaves(tree):
        for x in (leaf if isinstance(leaf, list) else [leaf]):
            s = torch.sum(torch.square(x.to(torch.float32)))
            total = s if total is None else total + s
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float, floor: float) -> torch.Tensor:
    """min(1, max_norm / max(norm, floor)) on the device, with a true
    division (a Python number over a tensor is reciprocal-then-multiply in
    torch, which rounds twice)."""
    return torch.clamp(torch.full_like(norm, max_norm) / torch.clamp(norm, min=floor), max=1.0)


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return tree_map(lambda g: -lr * g, grads), state

    def leaf(p, g):
        u = -lr * g
        p.copy_(p + u)

    def donate(state, params):
        return state, [functools.partial(leaf, p) for p in tree_leaves(params)]

    return Optimizer(init, update, donate)


def momentum(lr: float, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params=None):
        new_m = tree_map(lambda m, g: beta * m + g, state, grads)
        if nesterov:
            upd = tree_map(lambda m, g: -lr * (beta * m + g), new_m, grads)
        else:
            upd = tree_map(lambda m: -lr * m, new_m)
        return upd, new_m

    def leaf(slot, p, g):
        box, key = slot
        m = box[key]
        if m.dtype == torch.result_type(m, g):
            m.mul_(beta)
            m.add_(g)
        else:                    # a bf16 moment and an f32 gradient: the new moment is f32
            m = box[key] = beta * m + g
        u = -lr * (beta * m + g) if nesterov else -lr * m
        p.copy_(p + u)

    def donate(state, params):
        return state, [functools.partial(leaf, slot, p)
                       for slot, p in zip(tree_slots(state), tree_leaves(params))]

    return Optimizer(init, update, donate)


class AdamState(NamedTuple):
    count: torch.Tensor
    mu: Any
    nu: Any


def _bias_corrections(count: torch.Tensor, b1: float, b2: float):
    """1 - b ** count in float32 (the bases made on the count's device, so
    no host-to-device copy)."""
    c32 = count.to(torch.float32)
    return (1 - torch.pow(torch.full_like(c32, b1), c32),
            1 - torch.pow(torch.full_like(c32, b2), c32))


def _adam_update(lr: float, b1: float, b2: float, eps: float, wd: float):
    """The update of adam (wd = 0) and adamw, one leaf at a time."""

    def update(grads, state, params=None):
        count = state.count + 1
        bc1, bc2 = _bias_corrections(count, b1, b2)

        def leaf(g, m, v, p=None):
            g = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * (g * g)
            u = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if wd:
                u = u - lr * wd * p.to(torch.float32)
            return u, m, v

        rest = (state.mu, state.nu) + ((params,) if wd else ())
        triples = tree_map(leaf, grads, *rest)
        part = lambda i: tree_map(lambda t: t[i], triples)  # noqa: E731
        return part(0), AdamState(count=count, mu=part(1), nu=part(2))

    return update


def _adam_donate(lr: float, b1: float, b2: float, eps: float, wd: float):
    """`_adam_update` and `apply_updates` in place, one leaf at a time.
    adam's init hands one zero tree to both moments, so a second moment
    that is its first moment's tensor is given storage of its own first."""

    def donate(state, params):
        count = state.count + 1
        bc1, bc2 = _bias_corrections(count, b1, b2)
        mu, nu = state.mu, state.nu
        if any(m is v for m, v in zip(tree_leaves(mu), tree_leaves(nu))):
            nu = tree_map(lambda m, v: v.clone() if m is v else v, mu, nu)

        def leaf(m, v, p, g):
            g = g.to(torch.float32)
            m.mul_(b1)
            m.add_((1 - b1) * g)
            v.mul_(b2)
            v.add_((1 - b2) * (g * g))
            u = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if wd:
                u = u - lr * wd * p.to(torch.float32)
            p.copy_(p + u)

        updates = [functools.partial(leaf, m, v, p)
                   for m, v, p in zip(tree_leaves(mu), tree_leaves(nu), tree_leaves(params))]
        return AdamState(count=count, mu=mu, nu=nu), updates

    return donate


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        count = torch.zeros((), dtype=torch.int32, device=_device(params))
        return AdamState(count=count, mu=z, nu=z)

    return Optimizer(init, _adam_update(lr, b1, b2, eps, 0.0),
                     _adam_donate(lr, b1, b2, eps, 0.0))


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          wd: float = 0.01) -> Optimizer:
    return Optimizer(adam(lr, b1, b2, eps).init, _adam_update(lr, b1, b2, eps, wd),
                     _adam_donate(lr, b1, b2, eps, wd))


class AdafactorState(NamedTuple):
    count: torch.Tensor
    row: Any   # per-leaf row second moments (or the full moment of a < 2-D leaf)
    col: Any


def adafactor(lr: float = 1e-2, eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8) -> Optimizer:
    """Factored second-moment estimator (Shazeer & Stern 2018), memory
    O(rows + cols) per matrix, over the JAX layout: a per-layer group is
    one stacked leaf (module docstring)."""

    def shape(leaf):
        return ((len(leaf),) + tuple(leaf[0].shape) if isinstance(leaf, list)
                else tuple(leaf.shape))

    def device(leaf):
        return (leaf[0] if isinstance(leaf, list) else leaf).device

    def init(params):
        def rows(_, leaf):
            s = shape(leaf)
            return torch.zeros(s[:-1] if len(s) >= 2 else s, dtype=torch.float32,
                               device=device(leaf))

        def cols(_, leaf):
            s = shape(leaf)
            return torch.zeros(s[:-2] + s[-1:] if len(s) >= 2 else (), dtype=torch.float32,
                               device=device(leaf))

        return AdafactorState(count=torch.zeros((), dtype=torch.int32, device=_device(params)),
                              row=map_jax_leaves(rows, params, stack=True),
                              col=map_jax_leaves(cols, params, stack=True))

    def update(grads, state, params=None):
        count = state.count + 1
        beta = 1.0 - torch.pow(count.to(torch.float32), -decay)

        def upd_leaf(g, r, c, factored):
            g = g.to(torch.float32)
            g2 = torch.square(g) + eps
            if factored:
                new_r = beta * r + (1 - beta) * g2.mean(dim=-1)
                new_c = beta * c + (1 - beta) * g2.mean(dim=-2)
                denom = new_r.mean(dim=-1, keepdim=True)
                vr = new_r / torch.clamp(denom, min=eps)
                u = (g / torch.sqrt(vr)[..., None]
                     / torch.sqrt(torch.clamp(new_c, min=eps))[..., None, :])
            else:
                new_r = beta * r + (1 - beta) * g2
                new_c = c
                u = g / torch.sqrt(torch.clamp(new_r, min=eps))
            rms = torch.sqrt(torch.mean(torch.square(u)))
            scale = torch.clamp(rms / clip_threshold, min=1.0)
            return -lr * u / scale, new_r, new_c

        out = {}
        p_leaves = jax_leaves(params if params is not None else grads)
        for (path, g), (_, r), (_, c), (_, p) in zip(jax_leaves(grads), jax_leaves(state.row),
                                                     jax_leaves(state.col), p_leaves):
            out[path] = upd_leaf(stacked(g), r, c, len(shape(p)) >= 2)

        def unstack(path, g):
            u = out[path][0]
            return list(u.unbind(0)) if isinstance(g, list) else u

        upd = map_jax_leaves(unstack, grads)
        row = map_jax_leaves(lambda path, _: out[path][1], state.row)
        col = map_jax_leaves(lambda path, _: out[path][2], state.col)
        return upd, AdafactorState(count=count, row=row, col=col)

    return Optimizer(init, update, sharded=functools.partial(
        adafactor_sharded, lr=lr, eps=eps, clip_threshold=clip_threshold, decay=decay))


def _stacked_specs(specs: dict) -> dict:
    """{JAX-layout path: spec of the stacked leaf} from the parameters'
    {path: spec}: a per-layer group's leaf takes its layers' spec behind
    a None for the stacked dim."""
    out = {}
    for path, spec in specs.items():
        n_stack = sum(isinstance(k, int) for k in path)
        out[tuple(str(k) for k in path if not isinstance(k, int))] = (None,) * n_stack + spec
    return out


def adafactor_sharded(specs: dict, ctx, *, lr: float = 1e-2, eps: float = 1e-30,
                      clip_threshold: float = 1.0, decay: float = 0.8) -> Optimizer:
    """`adafactor` over this rank's parameter blocks on a mesh (`specs` the
    parameters' {path: spec}; only the `model` axis shards a parameter).
    For a factored stacked leaf of whole shape W and spec P, each rank
    holds the block of G; the state is held in `opt_state_shardings`'
    layout: row (W[:-1]) on P[:-1], col (W[:-2] + W[-1:]) on P[:-1] as
    well, i.e. its last dim on P[-2]'s axis.  The update:
      row mean over W[-1]: the block's sums, summed over `model` where P[-1]
        shards it; col mean over W[-2] likewise where P[-2] does;
      the col moment moved from its stored layout (last dim on P[-2]) to
        the block's (on P[-1]) for the update and back (all-gather, block);
      the row moment's mean, and the update's RMS, summed over `model`."""
    stacked_specs = _stacked_specs(specs)
    group, mp, rank = ctx.group("model"), ctx.size("model"), ctx.rank("model")

    def size(entry) -> int:
        if entry is None:
            return 1
        if entry != "model":
            raise ValueError(f"adafactor_sharded: a parameter sharded over {entry!r}; the "
                             "rules shard parameters over 'model' only")
        return mp

    def move(c: torch.Tensor, src, dst, pair: bool) -> torch.Tensor:
        """c's last dim from a block on `src` to a block on `dst` (paired
        blocks where the parameter's are, `sharding.params.paired`)."""
        if src is not None:
            c = comm.gather_(c, group, c.ndim - 1)
            if pair:
                c = join_blocks(list(c.chunk(mp, dim=-1)), c.ndim - 1, pair)
        if dst is not None:
            c = model_block(c, c.ndim - 1, mp, rank, pair).contiguous()
        return c

    def reduce(x: torch.Tensor, sharded: bool) -> torch.Tensor:
        return comm.all_reduce_(x, group) if sharded else x

    def whole_shape(path, leaf) -> tuple:
        block = ((len(leaf),) + tuple(leaf[0].shape) if isinstance(leaf, list)
                 else tuple(leaf.shape))
        return tuple(n * size(e) for n, e in zip(block, stacked_specs[path])), block

    def init(params):
        dev = _device(params)

        def rows(path, leaf):
            _, b = whole_shape(path, leaf)
            return torch.zeros(b[:-1] if len(b) >= 2 else b, dtype=torch.float32, device=dev)

        def cols(path, leaf):
            w, b = whole_shape(path, leaf)
            spec = stacked_specs[path]
            if len(b) < 2:
                return torch.zeros((), dtype=torch.float32, device=dev)
            if spec[-2] is not None and w[-1] % mp:
                raise ValueError(f"adafactor_sharded: {path}'s column moment would be "
                                 f"sharded unevenly ({w[-1]} over {mp})")
            return torch.zeros(b[:-2] + (w[-1] // size(spec[-2]),), dtype=torch.float32,
                               device=dev)

        return AdafactorState(count=torch.zeros((), dtype=torch.int32, device=dev),
                              row=map_jax_leaves(rows, params, stack=True),
                              col=map_jax_leaves(cols, params, stack=True))

    def update(grads, state, params=None):
        count = state.count + 1
        beta = 1.0 - torch.pow(count.to(torch.float32), -decay)

        def upd_leaf(path, g, r, c, w):
            spec = stacked_specs[path]
            g = g.to(torch.float32)
            g2 = torch.square(g) + eps
            if len(w) >= 2:
                new_r = beta * r + (1 - beta) * reduce(g2.sum(dim=-1), spec[-1] is not None) / w[-1]
                c_use = move(c, spec[-2], spec[-1], paired(path))
                new_c = (beta * c_use
                         + (1 - beta) * reduce(g2.sum(dim=-2), spec[-2] is not None) / w[-2])
                denom = reduce(new_r.sum(dim=-1, keepdim=True), spec[-2] is not None) / w[-2]
                vr = new_r / torch.clamp(denom, min=eps)
                u = (g / torch.sqrt(vr)[..., None]
                     / torch.sqrt(torch.clamp(new_c, min=eps))[..., None, :])
                new_c = move(new_c, spec[-1], spec[-2], paired(path))
            else:
                new_r = beta * r + (1 - beta) * g2
                new_c = c
                u = g / torch.sqrt(torch.clamp(new_r, min=eps))
            n = 1
            for k in w:
                n *= k
            sq = reduce(torch.sum(torch.square(u)), any(e is not None for e in spec))
            rms = torch.sqrt(sq / n)
            scale = torch.clamp(rms / clip_threshold, min=1.0)
            return -lr * u / scale, new_r, new_c

        out = {}
        p_leaves = jax_leaves(params if params is not None else grads)
        for (path, g), (_, r), (_, c), (_, p) in zip(jax_leaves(grads), jax_leaves(state.row),
                                                     jax_leaves(state.col), p_leaves):
            out[path] = upd_leaf(path, stacked(g), r, c, whole_shape(path, p)[0])

        def unstack(path, g):
            u = out[path][0]
            return list(u.unbind(0)) if isinstance(g, list) else u

        upd = map_jax_leaves(unstack, grads)
        row = map_jax_leaves(lambda path, _: out[path][1], state.row)
        col = map_jax_leaves(lambda path, _: out[path][2], state.col)
        return upd, AdafactorState(count=count, row=row, col=col)

    return Optimizer(init, update)


def clip_by_global_norm(max_norm: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        scale = _clip_scale(global_norm(grads), max_norm, 1e-12)
        return tree_map(lambda g: g * scale, grads), state

    return Optimizer(init, update)


def chain(*opts: Optimizer) -> Optimizer:
    def init(params):
        return tuple(o.init(params) for o in opts)

    def update(grads, state, params=None):
        new_states = []
        for o, s in zip(opts, state):
            grads, s = o.update(grads, s, params)
            new_states.append(s)
        return grads, tuple(new_states)

    return Optimizer(init, update)


def make_optimizer(name: str, lr: float, **kw) -> Optimizer:
    table = {"sgd": sgd, "momentum": momentum, "adam": adam, "adamw": adamw,
             "adafactor": adafactor}
    try:
        return table[name](lr, **kw)
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; choose from {sorted(table)}") from None
