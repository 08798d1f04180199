"""Sustained-service harness: the async event engine as a long-running
streaming service (DESIGN.md §14).

Public surface:
  ServiceConfig / SustainedService
      -- the resumable segment engine + load generator: regenerates
         Γ/scenario traces in fixed-size segments of ONE open-ended
         seed-deterministic stream (`scenarios.ScenarioStream`) and
         chains the async loop's carry across segments — one segmented
         runner for every segment;
  observability
      -- pure per-event accounting: throughput, p50/p95/p99 commit
         latency, SLO attainment, buffer occupancy (`EventLog`,
         `summarize`).

CLI: ``PYTHONPATH=src python -m repro_torch.service.run --smoke`` writes a
versioned ``results/<name>/v####/service.json`` artifact + figures (on the
card; add ``--device cpu`` to run on the CPU).  The port of the JAX
package's `service`, with the same public surface.
"""
from .harness import ServiceConfig, SustainedService
from .observability import (
    EventLog,
    latency_percentiles,
    slo_attainment,
    summarize,
    throughput_events_per_s,
)

__all__ = [
    "ServiceConfig",
    "SustainedService",
    "EventLog",
    "latency_percentiles",
    "slo_attainment",
    "throughput_events_per_s",
    "summarize",
]
