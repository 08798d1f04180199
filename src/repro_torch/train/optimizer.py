"""Functional optimizers over parameter dicts — the two Table I uses.

The JAX package's GradientTransformation-style API, kept:

    opt = adam(1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

with the same arithmetic: sgd's update is -lr * g; adam keeps float32
moments and its bias corrections 1 - b ** count in float32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

__all__ = ["Optimizer", "apply_updates", "sgd", "adam", "make_optimizer"]

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], tuple[Params, Any]]  # (grads, state, params)


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return {k: -lr * g for k, g in grads.items()}, state

    return Optimizer(init, update)


class AdamState(NamedTuple):
    count: torch.Tensor
    mu: Params
    nu: Params


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params):
        z = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        count = torch.zeros((), dtype=torch.int32,
                            device=next(iter(params.values())).device)
        return AdamState(count=count, mu=z, nu=dict(z))

    def update(grads, state, params=None):
        count = state.count + 1
        g32 = {k: g.to(torch.float32) for k, g in grads.items()}
        mu = {k: b1 * state.mu[k] + (1 - b1) * g for k, g in g32.items()}
        nu = {k: b2 * state.nu[k] + (1 - b2) * (g * g) for k, g in g32.items()}
        c32 = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=c32.device), c32)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=c32.device), c32)
        upd = {k: -lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps) for k in mu}
        return upd, AdamState(count=count, mu=mu, nu=nu)

    return Optimizer(init, update)


def make_optimizer(name: str, lr: float, **kw) -> Optimizer:
    table = {"sgd": sgd, "adam": adam}
    try:
        return table[name](lr, **kw)
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; choose from {sorted(table)}") from None
