"""Event-level observability for the sustained service (DESIGN.md §14).

Pure numpy over a flat per-event log — no engine, clock, or artifact
dependencies — so the SLO/percentile arithmetic is unit-testable on
hand-built traces (tests/test_torch_service.py) and re-derivable from a
committed `service.json` artifact alone.

The wall-clock accounting model: every event i has an *arrival* time
(open loop: ``i / target_rate`` on the load generator's schedule; closed
loop: the wall time its segment entered the engine) and a *completion*
time (the wall time its segment's device results landed on the host).
Commit latency is their difference — for a batched segment engine this
charges each event the full segment residency, the honest (pessimistic)
per-event figure for a service that commits results segment-at-a-time.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "EventLog",
    "latency_percentiles",
    "slo_attainment",
    "throughput_events_per_s",
    "summarize",
]


@dataclasses.dataclass(frozen=True)
class EventLog:
    """One measured window of the service, one row per server event.

    All arrays share length E (validated at construction); times are
    seconds on the measurement clock (0 = window start).
    """

    arrival_s: np.ndarray       # (E,) load-generator arrival times
    complete_s: np.ndarray      # (E,) wall completion times
    sim_latency_s: np.ndarray   # (E,) simulated eq.-9 event latencies
    n_pending: np.ndarray       # (E,) buffer occupancy after the event

    def __post_init__(self):
        arrays = {f.name: np.asarray(getattr(self, f.name))
                  for f in dataclasses.fields(self)}
        sizes = {k: v.shape for k, v in arrays.items()}
        if any(v.ndim != 1 for v in arrays.values()) or \
                len({v.size for v in arrays.values()}) != 1:
            raise ValueError(
                f"EventLog fields must be 1-D and equal-length, got {sizes}")
        if arrays["arrival_s"].size == 0:
            raise ValueError("EventLog needs at least one event")
        for name, v in arrays.items():
            object.__setattr__(self, name, np.asarray(v, np.float64)
                               if name != "n_pending"
                               else np.asarray(v, np.int64))
        if (np.diff(self.arrival_s) < 0).any():
            raise ValueError("arrival times must be non-decreasing")
        if (self.complete_s < self.arrival_s).any():
            raise ValueError("an event cannot complete before it arrives")

    @property
    def events(self) -> int:
        return self.arrival_s.size

    def latencies_s(self) -> np.ndarray:
        """Per-event wall commit latency: completion - arrival."""
        return self.complete_s - self.arrival_s


def latency_percentiles(lat_s: np.ndarray,
                        qs: tuple[float, ...] = (50.0, 95.0, 99.0)) -> dict:
    """{"p50": ..., "p95": ..., "p99": ...} over a latency sample."""
    lat_s = np.asarray(lat_s, np.float64)
    if lat_s.size == 0:
        raise ValueError("percentiles need a non-empty latency sample")
    return {f"p{q:g}": float(np.percentile(lat_s, q)) for q in qs}


def slo_attainment(lat_s: np.ndarray, budget_s: float) -> float:
    """Fraction of events whose commit latency meets the budget."""
    if budget_s <= 0:
        raise ValueError(f"latency budget must be positive, got {budget_s}")
    lat_s = np.asarray(lat_s, np.float64)
    if lat_s.size == 0:
        raise ValueError("SLO attainment needs a non-empty latency sample")
    return float(np.mean(lat_s <= budget_s))


def throughput_events_per_s(log: EventLog) -> float:
    """Committed events per wall second over the measured window
    (first arrival to last completion)."""
    window = float(log.complete_s[-1] - log.arrival_s[0])
    if window <= 0:
        raise ValueError(f"degenerate measurement window: {window}s")
    return log.events / window


def summarize(log: EventLog, budget_s: float) -> dict:
    """The service's scalar observability row for one measured window."""
    lat = log.latencies_s()
    return {
        "events": int(log.events),
        "throughput_events_per_s": throughput_events_per_s(log),
        "latency_s": {
            **latency_percentiles(lat),
            "mean": float(lat.mean()),
            "max": float(lat.max()),
        },
        "slo": {
            "budget_s": float(budget_s),
            "attained": slo_attainment(lat, budget_s),
        },
        "buffer": {
            "mean_pending": float(log.n_pending.mean()),
            "max_pending": int(log.n_pending.max()),
        },
        "sim": {
            "total_time_s": float(log.sim_latency_s.sum()),
            "mean_event_latency_s": float(log.sim_latency_s.mean()),
        },
    }
