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
owns dispatch; this module only builds the event body).  The host reads
one scalar per event — whether anyone trains — besides the leader's own
reads (`core.leader_torch.host_int`).

Carry — the sync carry (params, draws, age) plus the event buffer:

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

`draws` is the learning plane's uniforms source (`fl.sim.training_draws`),
the counterpart of the JAX package's PRNG key.  With ``segmented=True``
the runner takes and returns the carry, and offsets the event index by
``data["t0"]``, so S segments of length L replay one run of S*L events.

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

from ..core.leader_torch import first_true, host_int
from .engine_common import (make_eval_fn, make_leader_branches, make_xs,
                            run_leader, train_clients)
from .server import aggregate_buffered, staleness_weight

__all__ = ["commit_event", "cell_event", "init_async_carry", "build_async_runner"]


def init_async_carry(params0: dict, draws: Callable[[], torch.Tensor], n: int):
    """The event loop's t=0 carry: fresh model, unit ages, empty buffer.

    `buf` and `base` are zero-filled and separate tensors (the loop
    scatters into them in place); a row is only read after a dispatch
    wrote it (`active` gates every commit), so the fill is unobservable."""
    def zeros():
        return {k: torch.zeros((n + 1,) + v.shape, dtype=v.dtype, device=v.device)
                for k, v in params0.items()}

    device = next(iter(params0.values())).device
    return (params0, draws, torch.ones(n, dtype=torch.int32, device=device),
            zeros(), zeros(), torch.zeros(n, dtype=torch.int32, device=device),
            torch.zeros(n, dtype=torch.float32, device=device),
            torch.zeros(n, dtype=torch.bool, device=device))


def commit_event(rem: torch.Tensor, active: torch.Tensor, buffer: int,
                 k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The buffered server's commit decision for one event.

    Args:
      rem:    (N,) float32 remaining upload time per device.
      active: (N,) bool in-flight mask (`rem` is meaningful where True).
      buffer: commit batch size M.
      k: the sub-channel count — the server drains at most K uploads per
        event.

    Returns (delta, commit): the event's latency (time until the M-th
    earliest in-flight upload lands; 0 when nothing is in flight) and the
    committed-device mask (every upload landing within `delta`, ties
    committing together, capped at the K earliest by (rem, id) order).
    """
    n = rem.shape[0]
    n_active = active.sum()
    r_sorted = torch.sort(torch.where(active, rem, torch.inf)).values
    m_idx = torch.clamp(torch.clamp_max(n_active, buffer) - 1, 0, n - 1)
    delta = torch.where(n_active > 0, r_sorted.index_select(0, m_idx.reshape(1))[0], 0.0)
    arrived = active & (rem <= delta)
    # Serve at most K uploads per event: rank arrivals by (rem, id) — the
    # sort is stable, so ties break by device id like the host leader.
    order = torch.argsort(torch.where(arrived, rem, torch.inf), stable=True)
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=rem.device))
    return delta, arrived & (rank < k)


def cell_event(branches, trainer, data, x, t: int, params: dict, draws,
               age, buf: dict, base: dict, disp_e, rem, active, busy=None, *,
               k: int, n: int) -> dict:
    """One cell's event of the buffered loop: the leader step over the FREE
    devices, the dispatch, and the buffered commit (K3) into `params`.

    Dispatched devices train from `params` when some device transmits
    (one host read) and their flights are scattered into `buf` / `base` IN
    PLACE; every other state tensor is returned anew.  `busy` (a bool
    scalar tensor) gates the commit: a busy cell commits nothing and its
    clocks do not advance — the two-tier engine's cell-commit gating
    (`fl.hier_async`).  The flat engine passes None.

    Returns dict(params, age, disp_e, rem, active) — the cell's new state —
    and the event's lead, tx, commit, delta (the event latency), cw (the
    committed slots' weights), energy, overflow (a dispatch onto a busy
    device: structurally False) and rem_dispatch.
    """
    device = age.device
    ndev = torch.arange(n, device=device)
    kslot = torch.arange(k, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)

    # ---- leader plane: busy devices lose Prop-1 feasibility, so AoU
    # selection re-prioritises over the FREE population ------------------
    feas_free = x["feas"] & ~active[None, :]
    lead = run_leader(branches, data["policy_idx"], age, feas_free, x)
    tx = lead["transmitted"]
    ch_g = torch.where(tx, lead["channel_of"], 0)
    t_dev = x["gamma"][ch_g, ndev]
    energy = torch.where(tx, x["energy"][ch_g, ndev], zero).sum()
    overflow = (tx & active).any()      # must be structurally False

    # ---- learning plane: dispatched devices train from the CURRENT
    # model, then fly.  Their device-indexed scatter sends empty slots to
    # the sacrificial row n, whose duplicate writes are unordered on CUDA:
    # harmless only because row n is never read. ---------------------------
    tx_ids = first_true(tx, k)
    cnt = tx.sum()
    if host_int(cnt) > 0:
        cp = train_clients(trainer, data, params, draws, tx_ids)
        ids_s = torch.where(kslot < cnt, tx_ids, n)
        for name, b in buf.items():
            b[ids_s] = cp[name]
            base[name][ids_s] = params[name]
    active = active | tx
    rem = torch.where(tx, t_dev, rem)
    disp_e = torch.where(tx, t, disp_e).to(torch.int32)

    # ---- commit: wait for the buffer-many earliest arrivals --------------
    delta, commit = commit_event(rem, active, data["buffer"], k)
    if busy is not None:
        delta = torch.where(busy, zero, delta)
        commit = commit & ~busy
    w_st = staleness_weight(t - disp_e, data["stale_exp"])
    cids = first_true(commit, k)
    cw = torch.where(kslot < commit.sum(), data["beta"][cids] * w_st[cids], zero)
    # Graft each committed flight's local progress onto the CURRENT model:
    # w_i + (w - b_i).  Fresh commits have b_i == w bitwise, so the
    # translation is an exact no-op in the sync limit.
    translated = {name: buf[name][cids] + (g - base[name][cids])
                  for name, g in params.items()}
    params = aggregate_buffered(params, translated, cw, data["server_lr"])

    # ---- post-commit state: AoU resets when the SERVER ingests the update;
    # surviving flights advance by the event's duration -------------------
    active = active & ~commit
    return dict(params=params, age=torch.where(commit, 1, age + 1).to(age.dtype),
                disp_e=disp_e, rem=torch.where(active, rem - delta, zero),
                active=active, lead=lead, tx=tx, commit=commit, delta=delta,
                cw=cw, energy=energy, overflow=overflow,
                rem_dispatch=torch.where(tx, t_dev, zero))


def build_async_runner(model, trainer, policies: Sequence[tuple[str, str]],
                       *, k: int, n: int, rounds: int, eval_mask: np.ndarray,
                       track_gradnorm: bool = False, segmented: bool = False):
    """One loop over server events, each one `cell_event`, then the eval.

    Mirrors `fl.sim._build_scan_runner` (same `data` dict, plus the async
    operands `buffer` (int), `stale_exp` and `server_lr` (float32 scalar
    tensors)).  Returns fn(data) -> ys, a dict of per-event tensors with a
    leading events axis, still on the device.

    With ``segmented=True`` the returned closure is instead
    ``fn(data, carry) -> (carry, ys)``: the caller owns the carry (seed it
    with `init_async_carry`, thread it across segments) and `data` also
    provides ``t0``, the absolute event index of the segment's first event.
    """
    n_clusters = int(math.ceil(n / k))

    def scan_events(data, carry):
        device = data["beta"].device
        branches = make_leader_branches(policies, data, k=k, n=n,
                                        n_clusters=n_clusters)
        ev = make_eval_fn(model, data, track_gradnorm)
        zero = torch.zeros((), dtype=torch.float32, device=device)
        xs = make_xs(data, rounds, eval_mask)
        t0 = data.get("t0", 0) if segmented else 0
        params, draws, age, buf, base, disp_e, rem, active = carry
        ys = []
        for r in range(rounds):
            x = {name: v[r] for name, v in xs.items()}
            t = t0 + x["t"]
            x["t"] = t
            out = cell_event(branches, trainer, data, x, t, params, draws, age,
                             buf, base, disp_e, rem, active, k=k, n=n)
            params, age, disp_e, rem, active = (
                out[name] for name in ("params", "age", "disp_e", "rem", "active"))
            loss, acc, gnorm = ev(params) if x["eval_mask"] else (zero, zero, zero)
            ys.append(dict(loss=loss, acc=acc, gnorm=gnorm, latency=out["delta"],
                           energy=out["energy"], selected=out["lead"]["selected"],
                           transmitted=out["tx"], age=age, committed=out["commit"],
                           n_pending=active.sum().to(torch.int32),
                           overflow=out["overflow"],
                           rem_dispatch=out["rem_dispatch"]))
        carry = (params, draws, age, buf, base, disp_e, rem, active)
        return carry, {name: torch.stack([y[name] for y in ys]) for name in ys[0]}

    if segmented:
        return scan_events

    def run(data):
        carry0 = init_async_carry(data["params0"], data["next_uniforms"], n)
        _, ys = scan_events(data, carry0)
        return ys

    return run
