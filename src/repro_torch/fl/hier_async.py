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

Every commit, at either tier, is one `server.aggregate_buffered` call (one
K3 launch on the card) per cell and one for the global tier per event,
whether or not anything commits: a commit that takes nothing is an exact
identity select, so the engine needs no host read to skip it.  The host
reads one scalar per cell per event — whether anyone in the cell trains —
besides the leader's own reads (`core.leader_torch.host_int`).

Segment resume: the carry is the loop's COMPLETE state, so
``build_hier_async_runner(..., segmented=True)`` returns a
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

from .async_loop import cell_event, commit_event
from .engine_common import cell_data, cell_x, make_eval_fn, make_leader_branches, make_xs
from .server import aggregate_buffered, staleness_weight

__all__ = ["init_hier_async_carry", "build_hier_async_runner"]


def init_hier_async_carry(params0: dict, draws: Callable[[], torch.Tensor],
                          n_cells: int, n: int):
    """The two-tier event loop's t=0 carry.

    Cell models start as exact copies of the global model; both buffer
    pairs are zero-filled, separate tensors (the loop scatters into them in
    place; reads are gated by the active masks, so the fill is
    unobservable).  `gbase` zeros make a never-flown cell's translated
    global slot come out to exactly the current global model, mirroring
    the sync engine's identity slot."""
    device = next(iter(params0.values())).device

    def zeros(lead: tuple[int, ...]) -> dict:
        return {name: torch.zeros(lead + v.shape, dtype=v.dtype, device=device)
                for name, v in params0.items()}

    def vec(dtype, shape=(n_cells,)):
        return torch.zeros(shape, dtype=dtype, device=device)

    pcell0 = {name: v.unsqueeze(0).repeat((n_cells,) + (1,) * v.ndim)
              for name, v in params0.items()}
    return (params0, draws,
            torch.ones((n_cells, n), dtype=torch.int32, device=device), pcell0,
            zeros((n_cells, n + 1)), zeros((n_cells, n + 1)),
            vec(torch.int32, (n_cells, n)), vec(torch.float32, (n_cells, n)),
            vec(torch.bool, (n_cells, n)),
            zeros((n_cells,)), zeros((n_cells,)),
            vec(torch.int32), vec(torch.float32), vec(torch.bool),
            vec(torch.float32))


def build_hier_async_runner(model, trainer,
                            policies: Sequence[tuple[str, str]], *,
                            n_cells: int, k: int, n: int, rounds: int,
                            eval_mask: np.ndarray,
                            track_gradnorm: bool = False,
                            segmented: bool = False):
    """One loop over global events, the cell list a Python loop in its
    body: each cell's event is the flat engine's `async_loop.cell_event`,
    gated on the cell's upstream flight, then the global commit tier.

    `data` is `fl.hierarchical._hier_scan_inputs`'s dict: a leading cell
    axis on the per-cell tensors (beta/clusters/fixed_ids (C, ...),
    x_all/y_all/m_all (C, N, B, ...)), gamma/feas/energy (rounds, C, K, N),
    perms (rounds, C, ...), plus the commit-policy operands `buffer` (int),
    `stale_exp`, `server_lr` (float32 scalar tensors) of the cell tier and
    `g_buffer`, `g_stale_exp`, `g_server_lr` of the global tier.  Returns
    fn(data) -> ys, per-event tensors still on the device; with
    ``segmented=True`` returns ``fn(data, carry) -> (carry, ys)`` instead
    (see the module docstring).
    """
    n_clusters = int(math.ceil(n / k))

    def scan_events(data, carry):
        device = data["beta"].device
        zero = torch.zeros((), dtype=torch.float32, device=device)
        cells = [cell_data(data, c) for c in range(n_cells)]
        branches = [make_leader_branches(policies, cells[c], k=k, n=n,
                                         n_clusters=n_clusters)
                    for c in range(n_cells)]
        ev = make_eval_fn(model, data, track_gradnorm)
        xs = make_xs(data, rounds, eval_mask)
        t0 = data.get("t0", 0) if segmented else 0
        (params, draws, age, pcell, buf, base, disp_e, rem, active,
         gbuf, gbase, g_disp, g_rem, g_active, g_w) = carry
        ys = []
        for r in range(rounds):
            x = {name: v[r] for name, v in xs.items()}
            t = t0 + x["t"]
            x["t"] = t
            # Gating snapshot: a cell whose flight is outstanding at the
            # global tier makes no local commits THIS event.
            busy = g_active.clone()

            ages, deltas, energies = [], [], []
            sel_all, tx_all, commit_all, remd_all = [], [], [], []
            overflow = torch.zeros((), dtype=torch.bool, device=device)
            for c in range(n_cells):
                # ---- cell c's event: dispatched devices train from the
                # CELL model; the commit is gated on the upstream flight.
                # The flights scatter into cell c's rows of buf/base. ------
                out = cell_event(branches[c], trainer, cells[c], cell_x(x, c), t,
                                 {name: v[c] for name, v in pcell.items()}, draws,
                                 age[c], {name: v[c] for name, v in buf.items()},
                                 {name: v[c] for name, v in base.items()},
                                 disp_e[c], rem[c], active[c], busy[c], k=k, n=n)
                p_c, commit = out["params"], out["commit"]
                for name, v in pcell.items():
                    v[c] = p_c[name]
                rem[c], active[c], disp_e[c] = out["rem"], out["active"], out["disp_e"]
                ages.append(out["age"])
                deltas.append(out["delta"])
                energies.append(out["energy"])

                # ---- a committing cell sends its model upstream as ONE
                # global flight ----------------------------------------------
                fly = commit.any()
                overflow = overflow | out["overflow"] | (fly & busy[c])
                for name, v in gbuf.items():
                    v[c] = torch.where(fly, p_c[name], v[c])
                    gbase[name][c] = torch.where(fly, params[name], gbase[name][c])
                g_rem[c] = torch.where(fly, out["delta"], g_rem[c])
                g_disp[c] = torch.where(fly, t, g_disp[c])
                g_w[c] = torch.where(fly, out["cw"].sum(), g_w[c])
                g_active[c] = g_active[c] | fly

                sel_all.append(out["lead"]["selected"])
                tx_all.append(out["tx"])
                commit_all.append(commit)
                remd_all.append(out["rem_dispatch"])

            # ---- global tier: the SAME commit rule, one tier up.  The
            # buffer is cell-indexed (slot c = cell c), so weight-0 slots
            # hold the same summation positions as the sync engine's
            # stacked cells ------------------------------------------------
            g_delta, g_commit = commit_event(g_rem, g_active, data["g_buffer"], n_cells)
            gw = torch.where(g_commit,
                             g_w * staleness_weight(t - g_disp, data["g_stale_exp"]),
                             zero)
            translated_g = {name: gbuf[name] + (g - gbase[name])
                            for name, g in params.items()}
            params = aggregate_buffered(params, translated_g, gw, data["g_server_lr"])

            g_active = g_active & ~g_commit
            g_rem = torch.where(g_active, g_rem - g_delta, zero)
            # Down-sync: every flight-free cell re-bases onto the new
            # global model (an exact select; see the module docstring).
            free = ~g_active
            pcell = {name: torch.where(free.reshape((n_cells,) + (1,) * g.ndim),
                                       g[None], pcell[name])
                     for name, g in params.items()}

            age = torch.stack(ages)
            loss, acc, gnorm = ev(params) if x["eval_mask"] else (zero, zero, zero)
            ys.append(dict(loss=loss, acc=acc, gnorm=gnorm, latency=g_delta,
                           energy=torch.stack(energies).sum(),
                           selected=torch.stack(sel_all),
                           transmitted=torch.stack(tx_all), age=age,
                           committed=torch.stack(commit_all),
                           cell_committed=g_commit,
                           latency_cells=torch.stack(deltas),
                           n_pending=active.sum().to(torch.int32),
                           g_pending=g_active.sum().to(torch.int32),
                           overflow=overflow,
                           rem_dispatch=torch.stack(remd_all)))
        carry = (params, draws, age, pcell, buf, base, disp_e, rem, active,
                 gbuf, gbase, g_disp, g_rem, g_active, g_w)
        return carry, {name: torch.stack([y[name] for y in ys]) for name in ys[0]}

    if segmented:
        return scan_events

    def run(data):
        carry0 = init_hier_async_carry(data["params0"], data["next_uniforms"],
                                       n_cells, n)
        _, ys = scan_events(data, carry0)
        return ys

    return run
