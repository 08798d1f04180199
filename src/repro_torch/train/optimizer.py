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

Every optimizer but a chain also updates in place (`Optimizer.donate`),
the counterpart of the JAX package's donated train step: `opt.donate(state,
params)` returns a `Donation`, the new state and one update per parameter
leaf, which takes that leaf's gradient and writes the new moments and the
new parameter into their own storage.  It computes the same expressions in
the same order as `update` and `apply_updates`, so its results are their
bits.  The elementwise four update in one pass, each on its leaf's clipped
float32 gradient.  Adafactor's clip spans a whole stacked leaf, so it
takes two, over chunks of each leaf fixed by its shape (`_chunks`: one
layer of a group, split further along its leading dims past
`CHUNK_ELEMENTS`): pass 1 (`Donation.first`, over every gradient leaf as
autograd gave it, with the clip scale, before any update) writes the
moments in place, keeps each chunk's row and column factors and sums the
squares of the update over the leaf's chunks in order; pass 2 (the
per-leaf updates, on the same raw gradients) recomputes each chunk's
update from its factors and writes the parameter; each reads a chunk of
its gradient as g.to(float32) * scale.  Its functional `update` runs
the same two passes, so the donated step is bitwise the functional one;
donated, a step holds the parameters, the gradients, the state and one
chunk's float32 temporaries at once.

On a mesh (per-rank code over this rank's parameter blocks,
`sharding.params.shard_tree`) the elementwise four run on the blocks as
they are.  Adafactor's statistics span whole rows and columns, so it has a
meshed form (`Optimizer.sharded`, `adafactor_sharded`, functional and
donated, on the same chunks of each block): the state in the
layout `sharding.partition.opt_state_shardings` gives it (the JAX
package's mirroring rule: a factored moment takes its parameter's spec
without the last dim), the row and column means and the update's RMS
summed over `model`, so the update is the unsharded one up to summation
order.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, NamedTuple

import torch

from ..sharding import comm
from ..sharding.params import join_blocks, model_block, paired
from ..sharding.partition import leaves_with_path
from .tree import jax_leaves, map_jax_leaves, tree_leaves, tree_map, tree_slots, tree_unflatten

__all__ = [
    "Optimizer",
    "Donation",
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
    "sum_squares",
    "make_optimizer",
]


# One parameter leaf's in-place update: takes its gradient, returns nothing.
LeafUpdate = Callable[[torch.Tensor], None]


class Donation(NamedTuple):
    """What `Optimizer.donate` returns: the new state, one LeafUpdate per
    leaf of tree_leaves(params), and `first`.  Where `first` is None each
    update takes its leaf's clipped float32 gradient; otherwise the step
    calls first(grads, scale) on the list of every gradient leaf as autograd
    gave it (tree_leaves order) and the clip scale (None: no clip) before
    the updates, which then take those gradients as they are (Adafactor's
    pass 1 and pass 2, module docstring)."""
    state: Any
    updates: list[LeafUpdate]
    first: Callable[[list, Any], None] | None = None


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]  # (grads, state, params)
    # (state, params) -> Donation; None for a chain.
    donate: Callable[[Any, Any], Donation] | None = None
    # (param specs {path: spec}, ShardCtx) -> the optimizer over this rank's
    # parameter blocks with its state in the sharding rules' layout; None
    # where the update is elementwise and runs on blocks as it is.
    sharded: Callable[[dict, Any], "Optimizer"] | None = None


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


# The most elements of a leaf that one float32 temporary of the global norm
# or of Adafactor's update holds, where the leaf's shape allows it (1 GiB).
CHUNK_ELEMENTS = 1 << 28


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """The sum of x's squares in float32; a tensor of more than
    CHUNK_ELEMENTS elements summed over runs of that many in order, so that
    no float32 copy of the whole tensor is made."""
    if x.numel() <= CHUNK_ELEMENTS:
        return torch.sum(torch.square(x.to(torch.float32)))
    total = None
    for part in x.reshape(-1).split(CHUNK_ELEMENTS):
        s = torch.sum(torch.square(part.to(torch.float32)))
        total = s if total is None else total + s
    return total


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in float32 (`sum_squares`),
    summed leaf by leaf in the JAX tree's order (a per-layer group layer by
    layer)."""
    total = None
    for _, leaf in jax_leaves(tree):
        for x in (leaf if isinstance(leaf, list) else [leaf]):
            s = sum_squares(x)
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
        return Donation(state, [functools.partial(leaf, p) for p in tree_leaves(params)])

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
        return Donation(state, [functools.partial(leaf, slot, p)
                                for slot, p in zip(tree_slots(state), tree_leaves(params))])

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
        return Donation(AdamState(count=count, mu=mu, nu=nu), updates)

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


def _blocks(shape: tuple) -> list[tuple]:
    """Index tuples that split a tensor of `shape` along its dims before
    the last two into blocks of at most CHUNK_ELEMENTS elements: whole
    where it fits, else runs of its first dim, else each index of its first
    dim split alike."""
    if len(shape) <= 2 or math.prod(shape) <= CHUNK_ELEMENTS:
        return [()]
    rest = math.prod(shape[1:])
    if rest > CHUNK_ELEMENTS:
        return [(i,) + t for i in range(shape[0]) for t in _blocks(shape[1:])]
    n = CHUNK_ELEMENTS // rest
    return [(slice(a, min(a + n, shape[0])),) for a in range(0, shape[0], n)]


def _chunks(shape: tuple, group: bool) -> list[tuple]:
    """The chunks of a JAX-layout leaf of stacked `shape`, as index tuples
    into it, fixed by the shape alone: a leaf of at most two dims is one
    chunk (a group's stacked 1-D leaf, whose column mean spans its layers;
    an embedding); a group's leaf is split by layer, and each layer (or a
    leaf outside a group) by `_blocks`.  Every statistic but the clip's RMS
    is then exact per chunk."""
    if len(shape) <= 2:
        return [()]
    if group:
        return [(i,) + t for i in range(shape[0]) for t in _blocks(shape[1:])]
    return _blocks(shape)


def _at(leaf, idx: tuple) -> torch.Tensor:
    """Chunk `idx` of a JAX-layout leaf: a view, or where the chunk is a
    whole group its layers stacked."""
    if isinstance(leaf, list):
        return leaf[idx[0]][idx[1:]] if idx else torch.stack(leaf)
    return leaf[idx]


def _parts(leaf, idx: tuple, u: torch.Tensor) -> list[tuple]:
    """(view of `leaf` at chunk idx, the part of u that goes there): one
    pair, or one per layer where the chunk is a whole group."""
    if not isinstance(leaf, list):
        return [(leaf[idx], u)]
    if not idx:
        return list(zip(leaf, u.unbind(0)))
    return [(leaf[idx[0]][idx[1:]], u)]


def _f32(g: torch.Tensor, scale: torch.Tensor | None) -> torch.Tensor:
    """g in float32, times the clip scale unless it is None: the bits of
    the step's clip, g.to(float32) * scale."""
    x = g.to(torch.float32)
    if scale is None:
        return x
    return x * scale if x is g else x.mul_(scale)


def _same(x):
    return x


class _LeafOps(NamedTuple):
    """How an Adafactor leaf's sums are completed: as they stand on one
    device; on a mesh summed over `model` where the leaf is sharded, and the
    column moment moved between its stored layout and the block's
    (`adafactor_sharded`)."""
    rows: Callable = _same       # sums over the last dim
    cols: Callable = _same       # sums over the second-last dim
    total: Callable = _same      # the clip's sum of squares
    col_in: Callable = _same     # the column moment, stored layout -> block's
    col_out: Callable = _same    # and back


def _u(g: torch.Tensor, factors: tuple) -> torch.Tensor:
    """A chunk's unclipped update from its float32 gradient and its
    factors: the row and column factors, or (a leaf of < 2 dims) the
    moment's root and None."""
    row, col = factors
    if col is None:
        return g / row
    return (g / row[..., None]).div_(col[..., None, :])


class _Leaf:
    """One JAX-layout leaf of an Adafactor step.  `stats` is pass 1 over
    its chunks (the new moments, each chunk's factors, and the clip's
    divisor from the sum of squares of u accumulated over the chunks in
    order); `update` is pass 2 on one chunk, u recomputed from the cached
    factors.  Both read a gradient chunk as g.to(float32) * grad_scale (the
    step's clip; as it is where that is None).  The functional and the
    donated step both run these, in this order, so the donated step's bits
    are the functional step's."""

    def __init__(self, whole: tuple, block: tuple, group: bool, ops: _LeafOps = _LeafOps()):
        self.whole, self.ops = whole, ops
        self.factored = len(whole) >= 2
        self.chunks = _chunks(block, group)
        self.of_layer: dict = {}     # layer (None: the leaf, or a whole group) -> chunk numbers
        for k, idx in enumerate(self.chunks):
            self.of_layer.setdefault(idx[0] if group and idx else None, []).append(k)
        self.factors: dict = {}
        self.grad_scale = self.scale = None

    def stats(self, grad, r, c, r_out, c_out, grad_scale, beta, eps: float,
              clip_threshold: float) -> None:
        """Pass 1 over `grad` (the JAX-layout leaf): the moments r, c into
        r_out, c_out (themselves when donated), chunk by chunk."""
        w, ops = self.whole, self.ops
        self.grad_scale = grad_scale
        total = None
        for k, idx in enumerate(self.chunks):
            g = _f32(_at(grad, idx), grad_scale)
            g2 = torch.square(g).add_(eps)
            if self.factored:
                new_r = beta * r[idx] + (1 - beta) * (ops.rows(g2.sum(dim=-1)) / w[-1])
                new_c = (beta * ops.col_in(c[idx])
                         + (1 - beta) * (ops.cols(g2.sum(dim=-2)) / w[-2]))
                del g2
                denom = ops.cols(new_r.sum(dim=-1, keepdim=True)) / w[-2]
                f = (torch.sqrt(new_r / torch.clamp(denom, min=eps)),
                     torch.sqrt(torch.clamp(new_c, min=eps)))
                c_out[idx].copy_(ops.col_out(new_c))
            else:
                new_r = beta * r[idx] + (1 - beta) * g2
                f = (torch.sqrt(torch.clamp(new_r, min=eps)), None)
            r_out[idx].copy_(new_r)
            self.factors[k] = f
            sq = torch.sum(_u(g, f).square_())
            total = sq if total is None else total + sq
        rms = torch.sqrt(ops.total(total) / math.prod(w))
        self.scale = torch.clamp(rms / clip_threshold, min=1.0)

    def update(self, g: torch.Tensor, k: int, lr: float) -> torch.Tensor:
        """Pass 2: -lr u / scale of chunk k from its gradient chunk g."""
        return _u(_f32(g, self.grad_scale), self.factors.pop(k)).mul_(-lr).div_(self.scale)


def _adafactor_steps(lr: float, eps: float, clip_threshold: float, decay: float,
                     leaf_of: Callable[[tuple, Any], _Leaf]):
    """(update, donate) of Adafactor over the leaves leaf_of(path, the
    parameters' JAX-layout leaf) describes: one device's, or a mesh's
    blocks (`adafactor_sharded`)."""

    def start(state):
        count = state.count + 1
        return count, 1.0 - torch.pow(count.to(torch.float32), -decay)

    def leaves(params, state):
        return [(path, leaf_of(path, p), p, r, c) for (path, p), (_, r), (_, c)
                in zip(jax_leaves(params), jax_leaves(state.row), jax_leaves(state.col))]

    def update(grads, state, params=None):
        count, beta = start(state)
        upd, rows, cols = {}, {}, {}
        for (path, leaf, _, r, c), (_, g) in zip(
                leaves(params if params is not None else grads, state), jax_leaves(grads)):
            rows[path] = torch.empty_like(r)
            cols[path] = torch.empty_like(c) if leaf.factored else c
            leaf.stats(g, r, c, rows[path], cols[path], None, beta, eps, clip_threshold)
            new = lambda x: torch.empty(x.shape, dtype=torch.float32, device=x.device)  # noqa: E731
            out = [new(x) for x in g] if isinstance(g, list) else new(g)
            for k, idx in enumerate(leaf.chunks):
                for o, v in _parts(out, idx, leaf.update(_at(g, idx), k, lr)):
                    o.copy_(v)
            upd[path] = out
        return (map_jax_leaves(lambda path, _: upd[path], grads),
                AdafactorState(count=count,
                               row=map_jax_leaves(lambda path, _: rows[path], state.row),
                               col=map_jax_leaves(lambda path, _: cols[path], state.col)))

    def donate(state, params):
        count, beta = start(state)
        by_path = {path: (leaf, p, r, c) for path, leaf, p, r, c in leaves(params, state)}
        held: dict = {}

        def first(grads: list, scale) -> None:
            for path, g in jax_leaves(tree_unflatten(params, grads)):
                leaf, _, r, c = by_path[path]
                leaf.stats(g, r, c, r, c, scale, beta, eps, clip_threshold)

        def write(path, layer, g):
            leaf, p, _, _ = by_path[path]
            if layer not in leaf.of_layer:
                # A group's stacked leaf is one chunk: its layers' gradients
                # are held until the last one comes.
                got = held.setdefault(path, {})
                got[layer] = g
                if len(got) < len(p):
                    return
                g, layer = [got[i] for i in range(len(p))], None
                del held[path]
            for k in leaf.of_layer[layer]:
                idx = leaf.chunks[k]
                chunk = _at(g, idx) if layer is None else g[idx[1:]]
                for t, v in _parts(p, idx, leaf.update(chunk, k, lr)):
                    t.copy_(v.add_(t))

        updates = [functools.partial(write, tuple(str(k) for k in path if not isinstance(k, int)),
                                     next((k for k in path if isinstance(k, int)), None))
                   for path, _ in leaves_with_path(params)]
        return Donation(AdafactorState(count=count, row=state.row, col=state.col), updates,
                        first)

    return update, donate


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

    def leaf_of(path, leaf):
        s = shape(leaf)
        return _Leaf(s, s, isinstance(leaf, list))

    update, donate = _adafactor_steps(lr, eps, clip_threshold, decay, leaf_of)
    return Optimizer(init, update, donate, sharded=functools.partial(
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
    parameters' {path: spec}; only the `model` axis shards a parameter),
    functional and donated, chunked as on one device (`_chunks` of the
    block).  For a factored stacked leaf of whole shape W and spec P, each
    rank holds the block of G; the state is held in `opt_state_shardings`'
    layout: row (W[:-1]) on P[:-1], col (W[:-2] + W[-1:]) on P[:-1] as
    well, i.e. its last dim on P[-2]'s axis.  Per chunk:
      row mean over W[-1]: the block's sums, summed over `model` where P[-1]
        shards it; col mean over W[-2] likewise where P[-2] does;
      the col moment moved from its stored layout (last dim on P[-2]) to
        the block's (on P[-1]) for the update and back (all-gather, block);
      the row moment's mean summed over `model` likewise;
    and per leaf the update's sum of squares, summed over `model` once
    after the chunks' local sums."""
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

    def leaf_of(path, leaf):
        w, b = whole_shape(path, leaf)
        spec = stacked_specs[path]
        total = functools.partial(reduce, sharded=any(e is not None for e in spec))
        if len(w) < 2:
            return _Leaf(w, b, isinstance(leaf, list), _LeafOps(total=total))
        pair = paired(path)
        return _Leaf(w, b, isinstance(leaf, list), _LeafOps(
            rows=functools.partial(reduce, sharded=spec[-1] is not None),
            cols=functools.partial(reduce, sharded=spec[-2] is not None),
            total=total,
            col_in=functools.partial(move, src=spec[-2], dst=spec[-1], pair=pair),
            col_out=functools.partial(move, src=spec[-1], dst=spec[-2], pair=pair)))

    update, donate = _adafactor_steps(lr, eps, clip_threshold, decay, leaf_of)
    return Optimizer(init, update, donate)


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
