"""Round-body pieces shared by the scan and async engines.

The async engine's bit-exact sync-limit contract holds only while both
engines run the SAME float ops for the leader step, the client-training
draw discipline and the eval path — so those pieces live here once,
imported by `fl.sim._build_scan_runner` and
`fl.async_loop.build_async_runner` (and by the hierarchy's two engines,
`fl.hierarchical` and `fl.hier_async`).  `sync_cell_round` is one cell's
whole sync round, run by the flat scan engine and, once per cell, by the
hierarchy's; the async event's counterpart is `fl.async_loop.cell_event`.
Everything here works over the `data` dict of `fl.sim._scan_inputs`; no
dispatch or history logic.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
from torch.func import functional_call, grad

from ..core.leader_torch import first_true, host_int, leader_round
from .server import aggregate

__all__ = ["make_leader_branches", "run_leader", "train_clients",
           "make_eval_fn", "make_xs", "cell_data", "cell_x", "sync_cell_round"]


def make_leader_branches(policies: Sequence[tuple[str, str]], data, *,
                         k: int, n: int, n_clusters: int) -> list[Callable]:
    """One `leader_round` closure per distinct (ds, sa) policy variant.

    Each branch takes ``(age, feasible, x)`` — the feasibility mask is an
    explicit operand so the async engine can knock busy devices out of
    Prop-1 (the scan engine passes ``x["feas"]`` unchanged).
    """
    def leader_branch(ds, sa):
        def branch(age, feas, x):
            return leader_round(
                age, data["beta"], x["gamma"], feas,
                x["sel_perm"], x["assign_perm"], x["t"],
                data["clusters"], data["fixed_ids"],
                ds=ds, sa=sa, k=k, n=n, n_clusters=n_clusters)
        return branch

    return [leader_branch(ds, sa) for ds, sa in policies]


def run_leader(branches, policy_idx: int, age, feasible, x) -> dict:
    """One leader step of the cell's policy variant.  Cells run one at a
    time, so the variant is a host index (the JAX package switches on a
    traced one to batch a policy grid)."""
    return branches[policy_idx](age, feasible, x)


def train_clients(trainer, data, params, next_uniforms: Callable[[], torch.Tensor],
                  tx_ids: torch.Tensor) -> dict:
    """The engines' shared training step and draw discipline: exactly one
    (K, local_steps, batch) uniforms block per training event, taken only
    when some device transmits — as the loop engine and the JAX package
    consume their streams.  Returns the stacked client parameters."""
    return trainer(params, data["x_all"][tx_ids], data["y_all"][tx_ids],
                   data["m_all"][tx_ids], next_uniforms())


def make_eval_fn(model, data, track_gradnorm: bool):
    """The eval-round branch: (loss, accuracy, grad-norm^2-if-tracked) as
    float32 scalar tensors on the device (no host sync)."""
    x_full, y_full = data["x_full"], data["y_full"]

    def full_loss(p):
        logits = functional_call(model, p, (x_full,))
        return model.loss_per_example(logits, y_full).mean()

    def ev(p):
        with torch.no_grad():
            logits = functional_call(model, p, (x_full,))
            loss = model.loss_per_example(logits, y_full).mean()
            acc = model.correct(logits, y_full).mean()
        if track_gradnorm:
            gn = sum((g * g).sum() for g in grad(full_loss)(p).values())
        else:
            gn = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss, acc, gn.to(torch.float32)

    return ev


def make_xs(data, rounds: int, eval_mask: np.ndarray) -> dict:
    """The per-round inputs both engines consume, each with a leading
    rounds axis: Γ slices, injected permutations, the eval mask (on the
    host, so the eval branch needs no sync) and the round index (Python
    ints)."""
    return dict(gamma=data["gamma"], feas=data["feas"],
                energy=data["energy"], sel_perm=data["sel_perms"],
                assign_perm=data["assign_perms"],
                eval_mask=np.asarray(eval_mask, bool),
                t=list(range(rounds)))


def cell_data(data: dict, c: int) -> dict:
    """Cell c's view of the hierarchy's `data` dict: the flat engines'
    per-cell tensors (beta, clusters, fixed_ids, client data)."""
    return dict(data, **{name: data[name][c] for name in (
        "beta", "clusters", "fixed_ids", "x_all", "y_all", "m_all")})


def cell_x(x: dict, c: int) -> dict:
    """Cell c's slice of one round's inputs (Γ, energy, permutations)."""
    return dict(x, **{name: x[name][c] for name in (
        "gamma", "feas", "energy", "sel_perm", "assign_perm")})


def sync_cell_round(branches, trainer, data, x, params, draws, age, *,
                    k: int, n: int) -> dict:
    """One cell's synchronous round on the device: the leader step, the
    eq.-9 barrier latency and energy of its transmitters, and — when some
    device transmits, which the host reads once — their local training
    from `params` and the cell's eq.-34 aggregate (K3).

    Returns dict(lead, latency, energy, params, slot_w): `params` is the
    aggregate, or the input model itself when nobody transmits; `slot_w`
    the (K,) slot weights (beta of each transmitter, 0 in empty slots).
    """
    device = age.device
    ndev = torch.arange(n, device=device)
    kslot = torch.arange(k, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    lead = run_leader(branches, data["policy_idx"], age, x["feas"], x)
    tx = lead["transmitted"]
    ch_g = torch.where(tx, lead["channel_of"], 0)
    t_dev = x["gamma"][ch_g, ndev]
    latency = torch.where(tx.any(), torch.where(tx, t_dev, -torch.inf).max(), zero)
    energy = torch.where(tx, x["energy"][ch_g, ndev], zero).sum()
    tx_ids = first_true(tx, k)
    cnt = tx.sum()
    slot_w = torch.where(kslot < cnt, data["beta"][tx_ids], zero)
    if host_int(cnt) > 0:
        cp = train_clients(trainer, data, params, draws, tx_ids)
        params = aggregate(params, cp, slot_w)
    return dict(lead=lead, latency=latency, energy=energy, params=params, slot_w=slot_w)
