"""Two-tier buffered async engine: the event loop of `fl.async_loop` run
per edge cell, committing into a global server that is ITSELF a buffered
staleness-weighted aggregator.  The port of the JAX package's
`fl/hier_async.py`.

Topology and timing model
-------------------------

Each of the C cells runs the buffered event loop over its own devices'
virtual clocks: the cell leader re-runs the Stackelberg step every global
event (busy devices drop out of the Prop-1 mask), dispatched devices train
from the CELL model `pcell[c]`, and their uploads fly for their own Γ-trace
duration.  When the cell's `buffer` earliest uploads land, the cell commits
them into `pcell[c]` exactly as the flat engine commits into its global
model — translated updates w_i + (p_c - b_i), weights beta_n * f(staleness)
— and the freshly committed cell model is then dispatched UPSTREAM as one
in-flight update to the global tier:

  gbuf[c]   the cell model in flight;
  gbase[c]  the global model the flight was translated against;
  g_rem[c]  its remaining upload time = the cell commit's event duration
            delta_c (the global tier's per-cell virtual clock is derived
            from cell commit-event times);
  g_w[c]    its weight mass = the cell commit's total committed weight.

The global server runs the SAME commit rule over cells that each cell runs
over devices: `commit_event(g_rem, g_active, g_buffer, C)` waits for the
`g_buffer` earliest cell flights, commits them with translated updates
gbuf[c] + (w - gbase[c]) weighted g_w[c] * f(staleness), and the event's
recorded latency is the global delta.

Two structural rules keep the hierarchy well-posed:

  * cell-commit gating — while a cell has a flight outstanding at the
    global tier (`g_active[c]`), it makes NO further local commits (its
    device clocks freeze; dispatches continue).  At most one flight per
    cell is ever outstanding, so the cell-indexed global buffer (slot c =
    cell c) structurally cannot overflow — the per-device invariant of the
    flat engine, lifted one tier.
  * down-sync — after a global commit, EVERY cell with no outstanding
    flight re-bases its cell model to the new global model (not only the
    cells that just committed: a quiet cell would otherwise train from a
    stale base forever).  Gating guarantees a re-based cell loses at most
    one uncommitted local commit — and in the degenerate limits below it
    loses exactly nothing.

Degenerate limits (tests/test_torch_hier_async.py):

  * full buffers at BOTH tiers: every dispatch commits locally the same
    event, every cell flight commits globally the same event, staleness is
    0 at both tiers (weight multiplier exactly 1.0), both translations
    vanish identically, and the recorded latency is max_c delta_c — the
    sync hierarchy's cell-parallel eq.-9 barrier.  Every arithmetic step
    reproduces `fl.hierarchical`'s scan engine bit for bit.
  * C == 1: the cell model tracks the global model bitwise (the single-slot
    global commit is an exact select), so the two-tier loop collapses to
    the flat `engine="async"` event loop bit for bit.

A `run_hier_many` group of G configs runs as ONE event loop
(`build_hier_async_group_runner`, the port of the JAX package's `vmap`):
every state tensor has a leading config axis, and cell c of every config is
one flat group (`engine_common.group_cell_data`) whose event is the flat
engine's `async_loop.group_event`, gated by each config's own upstream
flight.  Each config's rows are the bits it gets alone.

Every commit, at either tier, is one `server.aggregate_buffered` call (one
K3 launch on the card) per cell index for all G configs and one for the
global tier's (G, C) slots per event, whether or not anything commits: a
commit that takes nothing is an exact identity select, so the engine needs
no host read to skip it — rounds x (C + 1) launches, whatever G.  The host
reads one (G,) vector per cell index per event — which configs' cell trains
— besides the leader's own reads (`core.leader_torch.host_int`).

Segment resume: the carry is the loop's COMPLETE state, so
``build_hier_async_runner(..., segmented=True)`` (one config) returns a
``run(data, carry) -> (carry, ys)`` closure that chains S segments of
length L into the single run of length S*L bit for bit (``data["t0"]``
offsets the event index; `init_hier_async_carry` builds the t=0 carry).
The loop updates the carry's tensors in place.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

from .async_loop import commit_event, group_event
from .engine_common import (eval_cells, group_cell_data, group_data, make_eval_fn,
                            make_group_leader, make_xs, stack_cells)
from .server import aggregate_buffered, staleness_weight

__all__ = ["init_hier_async_carry", "build_hier_async_runner",
           "build_hier_async_group_runner"]


def _fresh_state(params: dict, draws: list, n_cells: int, n: int) -> tuple:
    """A group's t=0 carry from its configs' (G, ...) global models and
    draws.  Cell models start as exact copies of their config's global
    model, laid out by `stack_cells` so every (config, cell) block is
    aligned alike; both buffer pairs are zero-filled, separate tensors (the
    loop scatters into them in place; reads are gated by the active masks,
    so the fill is unobservable).  `gbase` zeros make a never-flown cell's
    translated global slot come out to exactly the current global model,
    mirroring the sync engine's identity slot."""
    g = len(draws)
    device = next(iter(params.values())).device

    def zeros(lead: tuple[int, ...]) -> dict:
        return {name: torch.zeros((g,) + lead + v.shape[1:], dtype=v.dtype, device=device)
                for name, v in params.items()}

    def vec(dtype, shape=(n_cells,)):
        return torch.zeros((g,) + shape, dtype=dtype, device=device)

    pcell = stack_cells([{name: v[b] for name, v in params.items()}
                         for b in range(g) for _ in range(n_cells)], (g, n_cells))
    return (params, draws,
            torch.ones((g, n_cells, n), dtype=torch.int32, device=device), pcell,
            zeros((n_cells, n + 1)), zeros((n_cells, n + 1)),
            vec(torch.int32, (n_cells, n)), vec(torch.float32, (n_cells, n)),
            vec(torch.bool, (n_cells, n)),
            zeros((n_cells,)), zeros((n_cells,)),
            vec(torch.int32), vec(torch.float32), vec(torch.bool),
            vec(torch.float32))


def _at(state, index):
    """A carry entry (a tensor or a dict of them) indexed on its lead axis."""
    return {k: v[index] for k, v in state.items()} if isinstance(state, dict) else state[index]


def _lift_carry(carry) -> tuple:
    """One config's carry as a group of one's (views: the in-place updates
    reach the caller's tensors)."""
    params, draws, *state = carry
    return (_at(params, None), [draws], *(_at(v, None) for v in state))


def _drop_config_axis(carry) -> tuple:
    params, draws, *state = carry
    return (_at(params, 0), draws[0], *(_at(v, 0) for v in state))


def init_hier_async_carry(params0: dict, draws: Callable[[], torch.Tensor],
                          n_cells: int, n: int):
    """The two-tier event loop's t=0 carry of one config (see
    `_fresh_state`)."""
    return _drop_config_axis(_fresh_state(stack_cells([params0]), [draws], n_cells, n))


def _event_loop(model, trainer, policies: Sequence[tuple[str, str]], *,
                n_cells: int, k: int, n: int, rounds: int, eval_mask: np.ndarray,
                track_gradnorm: bool):
    """fn(group, carry) -> (carry, ys): `rounds` global events over a
    group of G configs, the cell list a Python loop in each event's body:
    for each cell index c, `async_loop.group_event` over every config's
    cell c, gated on that config's upstream flight, then the global commit
    tier over the (G, C) slots.  ys holds per-event tensors (events, G, ...)
    on the device.  The event index starts at ``group.get("t0", 0)``."""
    n_clusters = int(math.ceil(n / k))

    def scan_events(data, carry):
        configs = data["cells"]
        device = data["beta"].device
        zero = torch.zeros((), dtype=torch.float32, device=device)
        zeros = torch.zeros(len(configs), dtype=torch.float32, device=device)
        cells = [group_cell_data(data, c) for c in range(n_cells)]
        leaders = [make_group_leader(policies, cells[c], k=k, n=n, n_clusters=n_clusters)
                   for c in range(n_cells)]
        evs = [make_eval_fn(model, d, track_gradnorm) for d in configs]
        xs = [make_xs(cells[c], rounds, eval_mask) for c in range(n_cells)]
        t0 = data.get("t0", 0)
        (params, draws, age, pcell, buf, base, disp_e, rem, active,
         gbuf, gbase, g_disp, g_rem, g_active, g_w) = carry
        ys = []
        for r in range(rounds):
            t = t0 + r
            # Gating snapshot: a cell whose flight is outstanding at the
            # global tier makes no local commits THIS event.
            busy = g_active.clone()

            ages, deltas, energies = [], [], []
            sel_all, tx_all, commit_all, remd_all = [], [], [], []
            overflow = torch.zeros(len(configs), dtype=torch.bool, device=device)
            for c in range(n_cells):
                # ---- cell c of every config: dispatched devices train from
                # the CELL model; the commit is gated on the upstream
                # flight.  The flights scatter into the cell's rows of
                # buf/base. ---------------------------------------------------
                x = {name: v[r] for name, v in xs[c].items()}
                x["t"] = t
                out = group_event(leaders[c], trainer, cells[c], x, t,
                                  {name: v[:, c] for name, v in pcell.items()}, draws,
                                  age[:, c], {name: v[:, c] for name, v in buf.items()},
                                  {name: v[:, c] for name, v in base.items()},
                                  disp_e[:, c], rem[:, c], active[:, c], busy[:, c],
                                  k=k, n=n)
                p_c, commit = out["params"], out["commit"]
                for name, v in pcell.items():
                    v[:, c] = p_c[name]
                rem[:, c], active[:, c], disp_e[:, c] = out["rem"], out["active"], out["disp_e"]
                ages.append(out["age"])
                deltas.append(out["delta"])
                energies.append(out["energy"])

                # ---- a committing cell sends its model upstream as ONE
                # global flight ----------------------------------------------
                fly = commit.any(-1)
                overflow = overflow | out["overflow"] | (fly & busy[:, c])
                for name, v in gbuf.items():
                    f = fly.reshape(fly.shape + (1,) * (v.dim() - 2))
                    v[:, c] = torch.where(f, p_c[name], v[:, c])
                    gbase[name][:, c] = torch.where(f, params[name], gbase[name][:, c])
                g_rem[:, c] = torch.where(fly, out["delta"], g_rem[:, c])
                g_disp[:, c] = torch.where(fly, t, g_disp[:, c])
                g_w[:, c] = torch.where(fly, out["cw"].sum(-1), g_w[:, c])
                g_active[:, c] = g_active[:, c] | fly

                sel_all.append(out["lead"]["selected"])
                tx_all.append(out["tx"])
                commit_all.append(commit)
                remd_all.append(out["rem_dispatch"])

            # ---- global tier: the SAME commit rule, one tier up, every
            # config's in one K3 launch.  The buffer is cell-indexed (slot c
            # = cell c), so weight-0 slots hold the same summation positions
            # as the sync engine's stacked cells ------------------------------
            g_delta, g_commit = commit_event(g_rem, g_active, data["g_buffer"], n_cells)
            gw = torch.where(g_commit,
                             g_w * staleness_weight(t - g_disp, data["g_stale_exp"][:, None]),
                             zero)
            translated_g = {name: gbuf[name] + (g[:, None] - gbase[name])
                            for name, g in params.items()}
            params = aggregate_buffered(params, translated_g, gw, data["g_server_lr"])

            g_active = g_active & ~g_commit
            g_rem = torch.where(g_active, g_rem - g_delta[:, None], zero)
            # Down-sync: every flight-free cell re-bases onto the new
            # global model (an exact select; see the module docstring),
            # in place, so the cell models keep their layout.
            free = ~g_active
            for name, g in params.items():
                v = pcell[name]
                torch.where(free.reshape(free.shape + (1,) * (v.dim() - 2)), g[:, None], v,
                            out=v)

            age = torch.stack(ages, 1)
            loss, acc, gnorm = (eval_cells(evs, params) if eval_mask[r]
                                else (zeros, zeros, zeros))
            ys.append(dict(loss=loss, acc=acc, gnorm=gnorm, latency=g_delta,
                           energy=torch.stack(energies, -1).sum(-1),
                           selected=torch.stack(sel_all, 1),
                           transmitted=torch.stack(tx_all, 1), age=age,
                           committed=torch.stack(commit_all, 1),
                           cell_committed=g_commit,
                           latency_cells=torch.stack(deltas, 1),
                           n_pending=active.sum((1, 2)).to(torch.int32),
                           g_pending=g_active.sum(-1).to(torch.int32),
                           overflow=overflow,
                           rem_dispatch=torch.stack(remd_all, 1)))
        carry = (params, draws, age, pcell, buf, base, disp_e, rem, active,
                 gbuf, gbase, g_disp, g_rem, g_active, g_w)
        return carry, {name: torch.stack([y[name] for y in ys]) for name in ys[0]}

    return scan_events


def build_hier_async_group_runner(model, trainer,
                                  policies: Sequence[tuple[str, str]], *,
                                  n_cells: int, k: int, n: int, rounds: int,
                                  eval_mask: np.ndarray, track_gradnorm: bool = False):
    """fn(group) -> ys: one event loop over a `run_hier_many` group of G
    configs from the t=0 carry.

    `group` is `engine_common.group_data` of the configs'
    `fl.hierarchical._hier_scan_inputs` dicts, each with the commit operands
    `buffer` (int), `stale_exp`, `server_lr` (float32 scalar tensors) of the
    cell tier and `g_buffer`, `g_stale_exp`, `g_server_lr` of the global
    tier.  ys holds per-event tensors (events, G, ...), still on the device.
    """
    loop = _event_loop(model, trainer, policies, n_cells=n_cells, k=k, n=n,
                       rounds=rounds, eval_mask=eval_mask, track_gradnorm=track_gradnorm)

    def run(data):
        configs = data["cells"]
        params = stack_cells([d["params0"] for d in configs])
        return loop(data, _fresh_state(params, [d["next_uniforms"] for d in configs],
                                       n_cells, n))[1]

    return run


def build_hier_async_runner(model, trainer,
                            policies: Sequence[tuple[str, str]], *,
                            n_cells: int, k: int, n: int, rounds: int,
                            eval_mask: np.ndarray,
                            track_gradnorm: bool = False,
                            segmented: bool = False):
    """One config's two-tier event loop: `build_hier_async_group_runner` on
    a group of one.

    `data` is one config's `fl.hierarchical._hier_scan_inputs` dict (a
    leading cell axis on the per-cell tensors, gamma/feas/energy (rounds, C,
    K, N), perms (rounds, C, ...)) plus the commit operands of both tiers.
    Returns fn(data) -> ys, per-event tensors still on the device; with
    ``segmented=True`` returns ``fn(data, carry) -> (carry, ys)`` instead
    (see the module docstring).
    """
    loop = _event_loop(model, trainer, policies, n_cells=n_cells, k=k, n=n,
                       rounds=rounds, eval_mask=eval_mask, track_gradnorm=track_gradnorm)

    def run_segment(data, carry):
        carry, ys = loop(group_data([data]), _lift_carry(carry))
        return _drop_config_axis(carry), {name: v[:, 0] for name, v in ys.items()}

    if segmented:
        return run_segment

    def run(data):
        return run_segment(data, init_hier_async_carry(data["params0"], data["next_uniforms"],
                                                       n_cells, n))[1]

    return run
