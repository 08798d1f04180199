"""Training and serving steps of the model zoo (PyTorch copy of the JAX
package's `train/train_step.py`).

train_step folds the paper's eq.-(34) aggregation into the loss
(`models.transformer.lm_loss`): each batch row is a device-cohort whose
contribution is scaled by its Stackelberg selection weight
(batch["fl_weights"]), so one backward pass gives the weighted FedAvg
gradient.  The serving steps live in `serve_step.py` and are re-exported
here, where the JAX package has them.

On a mesh (`ctx=ShardCtx(mesh=...)`, per-rank code under
`torch.distributed`), each rank holds its blocks of the parameters and
optimizer state (`sharding.params.shard_tree`) and its data shard of the
batch; the step all-reduces every gradient over the data axes (each
parameter is replicated over them; the gradient of its `model` block is
already complete, `sharding.comm`), takes the global norm over each
sharded leaf's blocks once (their squares summed over `model`) and each
replicated leaf once, and updates its blocks in place or functionally as
unsharded.  The JAX package gets the same from the gradient all-reduce
XLA inserts.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models.transformer import lm_loss, param_specs
from ..sharding import comm
from ..sharding.ctx import ShardCtx, meshed
from ..sharding.partition import leaves_with_path
from .optimizer import Optimizer, _clip_scale, apply_updates, global_norm, sum_squares
from .serve_step import make_prefill_step, make_serve_step
from .tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["make_train_step", "make_grad_fn", "make_prefill_step", "make_serve_step",
           "mesh_optimizer"]


def mesh_optimizer(cfg: ArchConfig, opt: Optimizer, ctx: ShardCtx | None) -> Optimizer:
    """The optimizer the meshed step runs on this rank's blocks: `opt`
    itself where it is elementwise, its sharded form (`Optimizer.sharded`:
    Adafactor) otherwise; `opt` without a mesh.  Its `init` gives the
    state of the rank's blocks in `opt_state_shardings`' layout."""
    if not meshed(ctx) or opt.sharded is None:
        return opt
    return opt.sharded(param_specs(cfg, ctx.mesh, ctx.ep_size), ctx)


def _meshed_reduce(grads: list, loss: torch.Tensor, sharded: list[bool], ctx: ShardCtx):
    """The meshed step's reductions, in place on `grads`: each gradient
    summed over the data axes, the loss's shares likewise; the global norm
    over every sharded leaf's blocks (summed over `model`) and every
    replicated leaf once.  Returns (loss, grad_norm)."""
    loss = loss.detach().clone()
    if ctx.batch_sharded:
        group = ctx.dp_group()
        for g in grads:
            comm.all_reduce_(g, group)
        comm.all_reduce_(loss, group)
    sq = [torch.zeros((), dtype=torch.float32, device=loss.device) for _ in range(2)]
    for g, is_sharded in zip(grads, sharded):
        sq[is_sharded] = sq[is_sharded] + sum_squares(g)
    comm.all_reduce_(sq[1], ctx.group("model"))
    return loss, torch.sqrt(sq[0] + sq[1])


def make_grad_fn(cfg: ArchConfig, *, remat: bool = True, ctx: ShardCtx | None = None):
    """Returns grad_fn(params, batch) -> (grads, metrics): the gradient of
    `lm_loss` by autograd as a list in `tree_leaves(params)` order (zeros
    for a leaf the loss does not reach) and the metrics {"loss",
    "grad_norm", "aux"} on the parameters' device.  The gradient half of
    `make_train_step`'s step.  With a meshed `ctx`: this rank's blocks of
    the gradient, summed over the data axes, the whole batch's loss and
    the global norm (the module docstring)."""
    if meshed(ctx):
        specs = param_specs(cfg, ctx.mesh, ctx.ep_size)

    def grad_fn(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, extras = lm_loss(cfg, tree_unflatten(params, leaves), batch, remat=remat,
                                   ctx=ctx)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        del leaves
        if meshed(ctx):
            sharded = [any(e is not None for e in specs[path])
                       for path, _ in leaves_with_path(params)]
            loss, gnorm = _meshed_reduce(grads, loss, sharded, ctx)
        else:
            gnorm = global_norm(tree_unflatten(params, grads))
        return grads, {"loss": loss.detach(), "grad_norm": gnorm,
                       "aux": extras["aux"].detach()}

    return grad_fn


def make_train_step(cfg: ArchConfig, opt: Optimizer, *, remat: bool = True,
                    clip_norm: float = 1.0, donate: bool = False,
                    ctx: ShardCtx | None = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): the loss and its gradient by autograd, the gradient's global
    norm, the clip to `clip_norm` (none if 0), the optimizer update.  The
    metrics {"loss", "grad_norm", "aux"} stay on the parameters' device.
    remat=True recomputes each sublayer in the backward pass.

    donate=True is the JAX package's donated step (`donate_argnums=(0, 1)`
    of its dry run): the caller hands over `params` and `opt_state`, and
    the step clips and updates one leaf at a time in their storage
    (`Optimizer.donate`), dropping each gradient leaf once it is used.
    Adafactor first runs its pass 1 over all the gradient leaves (its
    moments, in place, and each leaf's clip), then the per-leaf writes,
    both reading the gradients chunk by chunk with the clip scale applied
    per chunk; the elementwise four take each leaf's clipped float32
    gradient.  It returns the `params` tree it was given, and
    computes the bits of donate=False, which holds the old and the new
    trees at once.  A chain cannot be donated.

    The port's K4 and K5 kernels have no backward, nor do the JAX
    package's Pallas kernels, so a config with attn_impl or rwkv_wkv_impl
    "pallas" is refused: training runs the "ref" paths.

    ctx: None (or mesh=None) is the single-device step above; a meshed
    ShardCtx runs the per-rank step of the module docstring on this rank's
    parameter and state blocks and batch shard (the metrics: the whole
    batch's loss, the global gradient norm, the whole batch's aux).  Its
    donated form is bitwise its functional form on the same mesh.  An
    optimizer whose statistics span a leaf (Adafactor) runs in its sharded
    form (`mesh_optimizer`), functional or donated, whose `init` gives the
    state it takes."""
    for field, kernel in (("attn_impl", "flash_attention (K4)"),
                          ("rwkv_wkv_impl", "rwkv6_wkv (K5)")):
        if getattr(cfg, field) == "pallas":
            raise NotImplementedError(
                f"make_train_step: {cfg.name} has {field}='pallas', but the {kernel} kernel "
                "has no backward kernel, and the JAX package cannot differentiate its "
                f"Pallas kernels either; train with {field}='ref'")
    opt = mesh_optimizer(cfg, opt, ctx)
    if donate and opt.donate is None:
        raise ValueError("make_train_step(donate=True) updates each leaf in place; a chain "
                         "has no in-place update (sgd, momentum, adam, adamw and adafactor "
                         "have one): pass donate=False")

    grad_fn = make_grad_fn(cfg, remat=remat, ctx=ctx)

    def train_step(params, opt_state, batch):
        grads, metrics = grad_fn(params, batch)
        gnorm = metrics["grad_norm"]
        if donate:
            scale = _clip_scale(gnorm, clip_norm, 1e-9) if clip_norm > 0 else None
            opt_state, updates, first = opt.donate(opt_state, params)
            if first is not None:
                first(grads, scale)                 # the updates clip as they read
            for i, update in enumerate(updates):
                g, grads[i] = grads[i], None
                if first is None and scale is not None:
                    g = g.to(torch.float32) * scale
                update(g)
            return params, opt_state, metrics
        grads = tree_unflatten(params, grads)
        if clip_norm > 0:
            # The JAX package's bf16 gradient times its f32 scale is f32.
            scale = _clip_scale(gnorm, clip_norm, 1e-9)
            grads = tree_map(lambda g: g.to(torch.float32) * scale, grads)
        updates, opt_state = opt.update(grads, opt_state, params)
        del grads
        params = apply_updates(params, updates)
        return params, opt_state, metrics

    return train_step
