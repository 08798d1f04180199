"""engine="async": the buffered, staleness-weighted event-timeline loop.

The synchronous engines close every round with the eq.-9 barrier — the
round is as slow as its slowest transmitter.  This module replaces the
barrier with a buffered server: the leader still runs the Stackelberg
step each *event* (AoU selection re-prioritises on the event stream, busy
devices drop out of the Prop-1 mask), dispatched devices train at once
from the current global model, and their uploads fly for their OWN
Γ-trace duration.  The server commits an event once the
`AsyncAggregation.buffer` earliest uploads have landed, weighting each
committed update by beta_n * f(staleness) (`server.staleness_weight`) and
stepping by the spec's server_lr (`server.aggregate_buffered`, kernel K3).

The port of the JAX package's `fl/async_loop.py`: one loop over `rounds`
server events with all state on the device (`fl.sim` builds the inputs and
owns dispatch; this module only builds the event body).  A `run_many`
group of B cells runs as one loop (`build_async_group_runner`, the port of
the JAX package's `vmap`): every state tensor below has a leading cell
axis, and each cell's rows are the bits it gets alone
(`fl.engine_common`).  The host reads one (B,) vector per event — which
cells train — besides the leader's own reads
(`core.leader_torch.host_int`).

Carry — the sync carry (params, draws, age) plus the event buffer, each
with a leading cell axis B:

  buf     dict, leaves (N+1, ...)   in-flight client models, device-indexed
                                    (row N is the sacrificial scatter
                                    target of empty slots);
  base    dict, leaves (N+1, ...)   the global model each flight was
                                    dispatched FROM; a commit applies the
                                    TRANSLATED update w_i + (w - b_i);
  disp_e  (N,) int32                event index of each flight's dispatch;
  rem     (N,) float32              remaining upload time, RELATIVE, so the
                                    full-buffer limit stays bit-exact;
  active  (N,) bool                 device has an uncommitted upload in
                                    flight (at most one per device).

`draws` lists the cells' learning-plane uniforms sources
(`fl.sim.training_draws`), the counterpart of the JAX package's PRNG keys.
`build_async_runner` is the one-cell runner (the service's): its data and
carry have no cell axis.  With ``segmented=True`` it takes and returns the
carry, and offsets the event index by ``data["t0"]``, so S segments of
length L replay one run of S*L events.

Full-buffer limit: with `buffer="full"` every in-flight upload commits at
its own event, so staleness is 0 (weight multiplier exactly 1.0), the
server_lr = 1 mixing is an exact select, the translation is an exact
no-op, and the event latency is the max over dispatched rem — the scan
engine's eq.-9 barrier, bit for bit.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.leader_torch import first_true, host_ints
from .engine_common import (at_channel, eval_cells, group_data, make_eval_fn,
                            make_group_leader, make_xs, stack_cells, train_cells)
from .server import aggregate_buffered, staleness_weight

__all__ = ["commit_event", "group_event", "init_async_carry", "build_async_runner",
           "build_async_group_runner"]


def _fresh_state(params: dict, lead: tuple, n: int) -> tuple:
    """(age, buf, base, disp_e, rem, active) at t=0, each with the leading
    shape `lead` (() for one cell, (B,) for a group): unit ages, an empty
    buffer.  `buf` and `base` are zero-filled and separate tensors (the
    loop scatters into them in place); a row is only read after a dispatch
    wrote it (`active` gates every commit), so the fill is unobservable."""
    def zeros():
        return {k: torch.zeros(lead + (n + 1,) + v.shape[len(lead):], dtype=v.dtype,
                               device=v.device) for k, v in params.items()}

    device = next(iter(params.values())).device
    return (torch.ones(lead + (n,), dtype=torch.int32, device=device), zeros(), zeros(),
            torch.zeros(lead + (n,), dtype=torch.int32, device=device),
            torch.zeros(lead + (n,), dtype=torch.float32, device=device),
            torch.zeros(lead + (n,), dtype=torch.bool, device=device))


def init_async_carry(params0: dict, draws: Callable[[], torch.Tensor], n: int):
    """The event loop's t=0 carry of one cell: fresh model, unit ages,
    empty buffer."""
    return (params0, draws, *_fresh_state(params0, (), n))


def _lift_carry(carry) -> tuple:
    """One cell's carry as a group of one's (views: the in-place scatters
    into buf / base reach the caller's tensors)."""
    params, draws, age, buf, base, disp_e, rem, active = carry
    lift = lambda tree: {k: v[None] for k, v in tree.items()}  # noqa: E731
    return (lift(params), [draws], age[None], lift(buf), lift(base), disp_e[None],
            rem[None], active[None])


def _drop_cell_axis(carry) -> tuple:
    params, draws, age, buf, base, disp_e, rem, active = carry
    drop = lambda tree: {k: v[0] for k, v in tree.items()}  # noqa: E731
    return (drop(params), draws[0], age[0], drop(buf), drop(base), disp_e[0], rem[0],
            active[0])


def commit_event(rem: torch.Tensor, active: torch.Tensor, buffer,
                 k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The buffered server's commit decision for one event, per cell.

    Args:
      rem:    (..., N) float32 remaining upload time per device.
      active: (..., N) bool in-flight mask (`rem` is meaningful where True).
      buffer: commit batch size M: an int, or a tensor of the leading shape
        (one per cell).
      k: the sub-channel count — the server drains at most K uploads per
        event.

    Returns (delta, commit): the event's latency (time until the M-th
    earliest in-flight upload lands; 0 when nothing is in flight) and the
    committed-device mask (every upload landing within `delta`, ties
    committing together, capped at the K earliest by (rem, id) order).
    """
    n = rem.shape[-1]
    n_active = active.sum(-1)
    r_sorted = torch.sort(torch.where(active, rem, torch.inf), dim=-1).values
    m_idx = torch.clamp(torch.clamp_max(n_active, buffer) - 1, 0, n - 1)
    delta = torch.where(n_active > 0, r_sorted.gather(-1, m_idx[..., None])[..., 0], 0.0)
    arrived = active & (rem <= delta[..., None])
    # Serve at most K uploads per event: rank arrivals by (rem, id) — the
    # sort is stable, so ties break by device id like the host leader.
    order = torch.argsort(torch.where(arrived, rem, torch.inf), dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(n, device=rem.device).expand_as(order))
    return delta, arrived & (rank < k)


def group_event(leader, trainer, data, x, t: int, params: dict, draws, age,
                buf: dict, base: dict, disp_e, rem, active, busy=None, *,
                k: int, n: int) -> dict:
    """One event of the buffered loop for a group of B cells: each cell's
    leader step over its FREE devices, the dispatch, and each cell's
    buffered commit — every cell's in one K3 launch — into `params`.

    Dispatched devices train from their cell's `params` when the cell has
    transmitters (the host reads the (B,) counts once) and their flights
    are scattered into `buf` / `base` IN PLACE; every other state tensor is
    returned anew.  `busy` ((B,) bool) gates the commit: a busy cell commits
    nothing and its clocks do not advance — the two-tier engine's
    cell-commit gating (`fl.hier_async`, which runs this event once per cell
    index over the cell of every config in its group, on views of its
    state).  The flat engine passes None.

    Returns dict(params, age, disp_e, rem, active) — the cells' new state —
    and the event's lead, tx, commit, delta (the event latency), cw (the
    committed slots' weights), energy, overflow (a dispatch onto a busy
    device: structurally False) and rem_dispatch, each with the cell axis.
    """
    device = age.device
    kslot = torch.arange(k, device=device)
    rows = torch.arange(age.shape[0], device=device)[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=device)

    # ---- leader plane: busy devices lose Prop-1 feasibility, so AoU
    # selection re-prioritises over the FREE population ------------------
    feas_free = x["feas"] & ~active[:, None, :]
    lead = leader(age, feas_free, x)
    tx = lead["transmitted"]
    ch_g = torch.where(tx, lead["channel_of"], 0)
    t_dev = at_channel(x["gamma"], ch_g)
    energy = torch.where(tx, at_channel(x["energy"], ch_g), zero).sum(-1)
    overflow = (tx & active).any(-1)      # must be structurally False

    # ---- learning plane: dispatched devices train from the CURRENT
    # model, then fly.  Their device-indexed scatter sends empty slots (and
    # every slot of a cell that does not train) to the sacrificial row n,
    # whose duplicate writes are unordered on CUDA: harmless only because
    # row n is never read. ---------------------------------------------------
    tx_ids = first_true(tx, k)
    cnt = tx.sum(-1)
    cp = train_cells(trainer, data, params, draws, tx_ids, host_ints(cnt))
    if cp is not None:
        ids_s = torch.where(kslot < cnt[:, None], tx_ids, n)
        for name, b in buf.items():
            b[rows, ids_s] = cp[name]
            base[name][rows, ids_s] = params[name][:, None]
    active = active | tx
    rem = torch.where(tx, t_dev, rem)
    disp_e = torch.where(tx, t, disp_e).to(torch.int32)

    # ---- commit: wait for the buffer-many earliest arrivals --------------
    delta, commit = commit_event(rem, active, data["buffer"], k)
    if busy is not None:
        delta = torch.where(busy, zero, delta)
        commit = commit & ~busy[:, None]
    w_st = staleness_weight(t - disp_e, data["stale_exp"][:, None])
    cids = first_true(commit, k)
    cw = torch.where(kslot < commit.sum(-1, keepdim=True),
                     data["beta"].gather(1, cids) * w_st.gather(1, cids), zero)
    # Graft each committed flight's local progress onto the CURRENT model:
    # w_i + (w - b_i).  Fresh commits have b_i == w bitwise, so the
    # translation is an exact no-op in the sync limit.
    translated = {name: buf[name][rows, cids] + (g[:, None] - base[name][rows, cids])
                  for name, g in params.items()}
    params = aggregate_buffered(params, translated, cw, data["server_lr"])

    # ---- post-commit state: AoU resets when the SERVER ingests the update;
    # surviving flights advance by the event's duration -------------------
    active = active & ~commit
    return dict(params=params, age=torch.where(commit, 1, age + 1).to(age.dtype),
                disp_e=disp_e, rem=torch.where(active, rem - delta[:, None], zero),
                active=active, lead=lead, tx=tx, commit=commit, delta=delta,
                cw=cw, energy=energy, overflow=overflow,
                rem_dispatch=torch.where(tx, t_dev, zero))


def _event_loop(model, trainer, policies: Sequence[tuple[str, str]], *, k: int, n: int,
                rounds: int, eval_mask: np.ndarray, track_gradnorm: bool):
    """fn(group, carry) -> (carry, ys): `rounds` events of `group_event`,
    each followed at eval events by every cell's eval; ys holds per-event
    tensors (events, B, ...) on the device.  The event index starts at
    ``group.get("t0", 0)``."""
    n_clusters = int(math.ceil(n / k))

    def scan_events(data, carry):
        b = data["beta"].shape[0]
        zeros = torch.zeros(b, dtype=torch.float32, device=data["beta"].device)
        leader = make_group_leader(policies, data, k=k, n=n, n_clusters=n_clusters)
        evs = [make_eval_fn(model, cell, track_gradnorm) for cell in data["cells"]]
        xs = make_xs(data, rounds, eval_mask)
        t0 = data.get("t0", 0)
        params, draws, age, buf, base, disp_e, rem, active = carry
        ys = []
        for r in range(rounds):
            x = {name: v[r] for name, v in xs.items()}
            t = t0 + x["t"]
            x["t"] = t
            out = group_event(leader, trainer, data, x, t, params, draws, age,
                              buf, base, disp_e, rem, active, k=k, n=n)
            params, age, disp_e, rem, active = (
                out[name] for name in ("params", "age", "disp_e", "rem", "active"))
            loss, acc, gnorm = (eval_cells(evs, params) if x["eval_mask"]
                                else (zeros, zeros, zeros))
            ys.append(dict(loss=loss, acc=acc, gnorm=gnorm, latency=out["delta"],
                           energy=out["energy"], selected=out["lead"]["selected"],
                           transmitted=out["tx"], age=age, committed=out["commit"],
                           n_pending=active.sum(-1).to(torch.int32),
                           overflow=out["overflow"],
                           rem_dispatch=out["rem_dispatch"]))
        carry = (params, draws, age, buf, base, disp_e, rem, active)
        return carry, {name: torch.stack([y[name] for y in ys]) for name in ys[0]}

    return scan_events


def build_async_group_runner(model, trainer, policies: Sequence[tuple[str, str]],
                             *, k: int, n: int, rounds: int, eval_mask: np.ndarray,
                             track_gradnorm: bool = False):
    """fn(group) -> ys: one event loop over a `run_many` group of B cells
    (`engine_common.group_data` of their `fl.sim._scan_inputs` dicts, plus
    the async operands `buffer` (int), `stale_exp` and `server_lr` (float32
    scalar tensors) per cell), from the t=0 carry.  ys holds per-event
    tensors (events, B, ...), still on the device."""
    loop = _event_loop(model, trainer, policies, k=k, n=n, rounds=rounds,
                       eval_mask=eval_mask, track_gradnorm=track_gradnorm)

    def run(data):
        cells = data["cells"]
        params = stack_cells([c["params0"] for c in cells])
        carry = (params, [c["next_uniforms"] for c in cells],
                 *_fresh_state(params, (len(cells),), n))
        return loop(data, carry)[1]

    return run


def build_async_runner(model, trainer, policies: Sequence[tuple[str, str]],
                       *, k: int, n: int, rounds: int, eval_mask: np.ndarray,
                       track_gradnorm: bool = False, segmented: bool = False):
    """One cell's event loop: `build_async_group_runner` on a group of one.

    `data` is one cell's `fl.sim._scan_inputs` dict plus the async operands
    `buffer` (int), `stale_exp` and `server_lr` (float32 scalar tensors).
    Returns fn(data) -> ys, a dict of per-event tensors with a leading
    events axis, still on the device.

    With ``segmented=True`` the returned closure is instead
    ``fn(data, carry) -> (carry, ys)``: the caller owns the carry (seed it
    with `init_async_carry`, thread it across segments) and `data` also
    provides ``t0``, the absolute event index of the segment's first event.
    """
    loop = _event_loop(model, trainer, policies, k=k, n=n, rounds=rounds,
                       eval_mask=eval_mask, track_gradnorm=track_gradnorm)

    def run_segment(data, carry):
        carry, ys = loop(group_data([data]), _lift_carry(carry))
        return _drop_cell_axis(carry), {name: v[:, 0] for name, v in ys.items()}

    if segmented:
        return run_segment

    def run(data):
        return run_segment(data, init_async_carry(data["params0"], data["next_uniforms"],
                                                  n))[1]

    return run
