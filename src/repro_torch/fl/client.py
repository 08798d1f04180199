"""Client-side local training (paper eq. 33 generalised to the Table-I
settings: minibatch local steps with SGD/Adam).

The K slots (one per sub-channel) train one after another from the same
global parameters; empty slots (no transmitting device) train on slot 0's
data and carry weight 0 at aggregation, as in the JAX package.
"""
from __future__ import annotations

import torch
from torch.func import functional_call, grad

from ..models.small import SmallModel
from ..train.optimizer import Optimizer, apply_updates

__all__ = ["make_local_trainer"]


def make_local_trainer(model: SmallModel, opt: Optimizer, *, batch_size: int,
                       local_steps: int):
    """Returns fn(params, x_slots, y_slots, mask_slots, uniforms) -> stacked
    params (every leaf gains a leading K axis), with x_slots (K, Bmax, ...),
    mask_slots (K, Bmax) and uniforms (K, local_steps, batch_size) float32
    in [0, 1): the minibatch draws.
    """

    def masked_loss(params, x, y, m):
        # Per-sample loss weighted by the padding mask.
        per = model.loss_per_example(functional_call(model, params, (x,)), y)
        return (per * m).sum() / torch.clamp_min(m.sum(), 1.0)

    loss_grad = grad(masked_loss)

    def one_client(params, x, y, mask, uniforms):
        opt_state = opt.init(params)
        # Minibatches sample only the device's REAL rows (mask prefix) via
        # floor(u * n_valid) in float32, so a trajectory cannot depend on
        # how far the slot buffer is padded.
        n_valid = torch.clamp_min(mask.sum(), 1.0)
        for u in uniforms:
            idx = (u * n_valid).to(torch.int32).long()    # u < 1 => idx < n_valid
            g = loss_grad(params, x[idx], y[idx], mask[idx])
            upd, opt_state = opt.update(g, opt_state, params)
            params = apply_updates(params, upd)
        return params

    def train_slots(params, x_slots, y_slots, mask_slots, uniforms):
        if uniforms.shape != (x_slots.shape[0], local_steps, batch_size):
            raise ValueError(f"uniforms must be (K, {local_steps}, {batch_size}), "
                             f"got {tuple(uniforms.shape)}")
        outs = [one_client(params, x_slots[i], y_slots[i], mask_slots[i], uniforms[i])
                for i in range(x_slots.shape[0])]
        return {k: torch.stack([o[k] for o in outs]) for k in params}

    return train_slots
