"""Sustained-service harness: the async event engine as a streaming service.

Every number the fixed-horizon harness (`fl.sim`) reports comes from a
closed world: the whole horizon is sampled, solved, and run once.  This
module drives the SAME buffered event engine (DESIGN.md §12) as a
long-running service instead (DESIGN.md §14):

  * the world is OPEN-ENDED — the dataset phase replays `fl.sim`'s rng
    prefix verbatim (`_sample_dataset` + clusters/fixed ids), then the
    environment continues forever through `scenarios.ScenarioStream`
    and the leader-plane permutations are drawn per round from the same
    world generator, so segment boundaries never reseed anything;
  * Γ and the scenario traces are regenerated in fixed-size segments
    (the solver is elementwise over pairs, so per-segment solves are
    bit-identical to slicing one whole-horizon solve): one kernel-K1
    launch per segment with a feasible pair (`ra_solver="step"`: the step
    driver over kernel K2), and the async loop's carry is chained across
    segments via `build_async_runner(..., segmented=True)` +
    `init_async_carry`, one runner built once for every segment;
  * a load generator replays the event stream at a target rate
    (events/s, open loop) or back-to-back (closed loop), and the
    observability layer (`service.observability`) records throughput,
    p50/p95/p99 commit latency, SLO attainment against a configurable
    budget, buffer occupancy, and steady-state loss/AoU.

The port of the JAX package's `service/harness.py`: the same world
stream, the same draws and the same record.  The segment-resume contract
— S segments of length L bit-identical to one segment of length S*L — is
pinned by tests/test_torch_service.py.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..core import RAResult, make_clusters
from ..core.monotonic import fixed_ra
from ..core.monotonic_torch import solve_pairs_fused, solve_pairs_step
from ..device import resolve_device
from ..fl import sim as fl_sim
from ..fl.async_loop import build_async_runner, init_async_carry
from ..fl.sim import (TABLE1, SimConfig, _async_spec,
                      _group_trainer_and_policies, _sample_dataset, _to_host)
from ..scenarios import ScenarioStream, apply_dynamics, scenario_name
from . import observability as obs

__all__ = ["ServiceConfig", "SustainedService"]

SERVICE_SCHEMA = 1


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """One sustained-service deployment.

    `sim` carries the cell shape (dataset, N, K, policy, scenario,
    aggregation, seed, learning settings); its fixed-horizon fields
    `rounds` and `eval_every` are ignored — the service horizon is
    open-ended and eval cadence is `eval_every_events`.
    """

    sim: SimConfig = SimConfig(aggregation="async")
    segment_events: int = 100           # events per segment
    eval_every_events: int | None = None  # None -> once per segment
    target_rate_events_per_s: float | None = None  # None -> closed loop
    latency_budget_s: float = 1.0       # SLO budget on wall commit latency
    warmup_segments: int = 1            # build/allocator warm-up, unmeasured

    def __post_init__(self):
        if self.segment_events < 1:
            raise ValueError(
                f"segment_events must be >= 1, got {self.segment_events}")
        ee = self.eval_every_events
        if ee is not None and (ee < 1 or self.segment_events % ee != 0):
            raise ValueError(
                f"eval_every_events must divide segment_events (the eval "
                f"mask is fixed per segment), got {ee} vs "
                f"{self.segment_events}")
        if (self.target_rate_events_per_s is not None
                and self.target_rate_events_per_s <= 0):
            raise ValueError("target_rate_events_per_s must be positive")
        if self.latency_budget_s <= 0:
            raise ValueError("latency_budget_s must be positive")
        if self.warmup_segments < 0:
            raise ValueError("warmup_segments must be >= 0")


class SustainedService:
    """The async event engine, resumable segment by segment.

    `run_segment()` serves the next `segment_events` events of the ONE
    long stream and returns the raw per-event ys (numpy); `serve()`
    wraps it in the load generator + observability and returns the
    artifact record.  All segments run through one segmented runner
    (`t0`, buffer, staleness, and server_lr are its operands).

    Args:
      cfg: the deployment.
      ra_solver: "fused" (kernel K1 solves each segment's pairs whole) or
        "step" (the per-iteration driver over kernel K2).
      device: "cuda[:i]" or "cpu"; None means the current CUDA device and
        raises when none is visible.
    """

    def __init__(self, cfg: ServiceConfig, *, ra_solver: str = "fused",
                 device=None):
        if ra_solver not in ("fused", "step"):
            raise ValueError(f"unknown ra_solver: {ra_solver}")
        self.cfg = cfg
        sim = cfg.sim
        self.spec = _async_spec(sim)
        self.wcfg = sim.wireless()
        self._ra_solver = ra_solver
        self.device = device = resolve_device(device)
        L = cfg.segment_events

        # ---- the open-ended world: fl.sim's dataset phase, then the
        # stream extension of the scenario + per-round permutations ------
        rng = np.random.default_rng(sim.seed)
        ds, part, beta, x_all, y_all, m_all = _sample_dataset(sim, rng, device)
        self._beta = beta
        clusters = make_clusters(sim.n_devices, sim.n_subchannels, rng)
        fixed_ids = rng.permutation(sim.n_devices)[: sim.n_subchannels]
        self._perm_rng = rng                      # continues per round
        self._stream = ScenarioStream(sim.seed, self.wcfg, sim.scenario)

        # ---- one segmented runner + the chained carry -------------------
        model, trainer, policies, _ = _group_trainer_and_policies([sim], device)
        ee = cfg.eval_every_events or L
        eval_mask = np.zeros(L, bool)
        eval_mask[ee - 1::ee] = True              # end of each eval block
        self._eval_offsets = np.nonzero(eval_mask)[0]
        self._run = build_async_runner(
            model, trainer, policies, k=sim.n_subchannels, n=sim.n_devices,
            rounds=L, eval_mask=eval_mask,
            track_gradnorm=sim.track_gradnorm, segmented=True)
        # The learning plane's draws, looked up at call time (the tests
        # inject the JAX package's); the draw source rides in the carry, so
        # chained segments continue one stream.
        params0, draws = fl_sim.training_draws(
            sim, sim.batch or TABLE1[sim.dataset]["batch"], device)
        self._carry = init_async_carry(params0, draws, sim.n_devices)

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        def i64(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

        self._static = dict(
            policy_idx=0,
            beta=torch.as_tensor(beta, dtype=torch.float32, device=device),
            x_all=x_all, y_all=y_all, m_all=m_all,
            x_full=torch.from_numpy(ds.x).to(device),
            y_full=torch.from_numpy(ds.y).to(device),
            clusters=i64(clusters),
            fixed_ids=i64(fixed_ids),
            buffer=self.spec.resolve_buffer(sim.n_devices, sim.n_subchannels),
            stale_exp=f32(self.spec.stale_exponent()),
            server_lr=f32(self.spec.server_lr),
        )
        self._events_served = 0

    @property
    def events_served(self) -> int:
        return self._events_served

    # ---- per-segment pipeline -------------------------------------------

    def _check_f32_priorities(self, horizon: int) -> None:
        # fl.sim._check_f32_priorities, restated for an open-ended
        # stream: AoU ages are bounded by the events served so far plus
        # the segment about to run, and the f32 age*beta priority
        # products must stay integer-exact below 2^24.
        worst = (self._events_served + horizon + 1) * float(self._beta.max())
        if worst >= 2 ** 24:
            raise ValueError(
                f"sustained service: after {self._events_served} events the "
                f"f32 age*beta priority products may reach {worst:.3g} >= "
                f"2^24 and lose exactness — restart the stream or shrink "
                f"data sizes")

    def _solve_segment(self, tr) -> RAResult:
        """Γ for one segment.  Elementwise over pairs, so per-segment
        solves concatenate to exactly the whole-horizon solve."""
        sim = self.cfg.sim
        emax_b = np.broadcast_to(tr.e_max_j[:, None, :], tr.h2_all.shape)
        if sim.policy.ra != "mo":
            return fixed_ra(self._beta[None, None, :], tr.h2_all,
                            self.wcfg, emax_b)
        shp = tr.h2_all.shape
        beta_b = np.broadcast_to(self._beta[None, None, :], shp)
        solve = (solve_pairs_fused if self._ra_solver == "fused"
                 else solve_pairs_step)
        flat = solve(beta_b.reshape(-1), tr.h2_all.reshape(-1), self.wcfg,
                     emax_b.reshape(-1), device=self.device)
        return RAResult(**{f.name: np.asarray(getattr(flat, f.name)).reshape(shp)
                           for f in dataclasses.fields(RAResult)})

    def run_segment(self) -> dict:
        """Serve the next `segment_events` events; returns numpy ys."""
        sim, L = self.cfg.sim, self.cfg.segment_events
        self._check_f32_priorities(L)
        tr = self._stream.next_segment(L)
        ra = self._solve_segment(tr)
        ra = apply_dynamics(ra, tr.avail, tr.slowdown, self._beta, self.wcfg)
        # Per-ROUND interleaved draws (sel then assign), never the
        # whole-horizon blocks `_prepare` uses: the stream position of a
        # draw must depend only on how many events have been served, not
        # on the segment size, or chaining would reshuffle the leader.
        perms = [(self._perm_rng.permutation(sim.n_devices),
                  self._perm_rng.permutation(sim.n_subchannels))
                 for _ in range(L)]
        dev = self.device
        data = dict(
            self._static,
            gamma=torch.as_tensor(ra.time_s, dtype=torch.float32, device=dev),
            feas=torch.as_tensor(ra.feasible, device=dev),
            energy=torch.as_tensor(np.where(np.isfinite(ra.energy_j),
                                            ra.energy_j, 0.0),
                                   dtype=torch.float32, device=dev),
            sel_perms=torch.as_tensor(np.stack([p[0] for p in perms]),
                                      dtype=torch.int64, device=dev),
            assign_perms=torch.as_tensor(np.stack([p[1] for p in perms]),
                                         dtype=torch.int64, device=dev),
            t0=self._events_served,
        )
        self._carry, ys = self._run(data, self._carry)
        ys = _to_host(ys)          # the segment ends when its ys are on the host
        self._events_served += L
        return ys

    # ---- the load generator + observability window ----------------------

    def serve(self, n_segments: int,
              progress: Callable[[str], None] | None = None) -> dict:
        """Replay `n_segments` measured segments (after the configured
        warm-up) and return the artifact record (`service.json` shape)."""
        if n_segments < 1:
            raise ValueError(f"n_segments must be >= 1, got {n_segments}")
        cfg, L = self.cfg, self.cfg.segment_events
        rate = cfg.target_rate_events_per_s

        warm_walls = []
        for _ in range(cfg.warmup_segments):
            t0 = time.perf_counter()
            self.run_segment()
            warm_walls.append(time.perf_counter() - t0)
            if progress:
                progress(f"warm-up segment: {warm_walls[-1]:.2f}s")

        served0 = self._events_served
        arrivals, completes, sim_lat, pend, mean_age = [], [], [], [], []
        losses, accs, eval_events = [], [], []
        seg_walls = []
        t_base = time.perf_counter()
        for s in range(n_segments):
            if rate is not None:
                # Open loop: event i of the window arrives at i/rate; a
                # segment may only enter the engine once its last event
                # has arrived.
                arr = np.arange(s * L, (s + 1) * L, dtype=np.float64) / rate
                wait = t_base + arr[-1] - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
            t_seg = time.perf_counter()
            ys = self.run_segment()
            t_done = time.perf_counter() - t_base
            seg_walls.append(time.perf_counter() - t_seg)
            if rate is None:
                arr = np.full(L, t_seg - t_base)
            arrivals.append(arr)
            completes.append(np.full(L, t_done))
            sim_lat.append(ys["latency"])
            pend.append(ys["n_pending"])
            mean_age.append(ys["age"].mean(axis=1))
            eval_events.append(served0 + s * L + self._eval_offsets)
            losses.append(ys["loss"][self._eval_offsets])
            accs.append(ys["acc"][self._eval_offsets])
            if progress:
                progress(f"segment {s + 1}/{n_segments}: "
                         f"{seg_walls[-1]:.2f}s "
                         f"({L / seg_walls[-1]:.1f} ev/s engine)")

        log = obs.EventLog(
            arrival_s=np.concatenate(arrivals),
            complete_s=np.concatenate(completes),
            sim_latency_s=np.concatenate(sim_lat),
            n_pending=np.concatenate(pend))
        summary = obs.summarize(log, cfg.latency_budget_s)
        summary["slo"]["target_rate_events_per_s"] = rate
        sim = cfg.sim
        return {
            "schema": SERVICE_SCHEMA,
            "kind": "sustained_service",
            "service": {
                "sim": _jsonable(dataclasses.asdict(sim)),
                "scenario": scenario_name(sim.scenario),
                "segment_events": L,
                "eval_every_events": cfg.eval_every_events or L,
                "target_rate_events_per_s": rate,
                "latency_budget_s": cfg.latency_budget_s,
                "warmup_segments": cfg.warmup_segments,
                "segments": n_segments,
                "events_measured": int(log.events),
                "events_served_total": int(self._events_served),
            },
            "summary": summary,
            "walls": {
                "warmup_s": warm_walls,
                "segment_s": seg_walls,
            },
            "events": {
                "event": (served0 + np.arange(log.events)).tolist(),
                "arrival_s": log.arrival_s.tolist(),
                "complete_s": log.complete_s.tolist(),
                "latency_s": log.latencies_s().tolist(),
                "sim_latency_s": log.sim_latency_s.tolist(),
                "n_pending": log.n_pending.tolist(),
                "mean_age": np.concatenate(mean_age).tolist(),
            },
            "steady_state": {
                "event": np.concatenate(eval_events).tolist(),
                "global_loss": np.concatenate(losses).astype(float).tolist(),
                "accuracy": np.concatenate(accs).astype(float).tolist(),
            },
        }


def _jsonable(obj):
    """Recursively coerce a config dict to JSON-serializable values."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return obj
