"""Paper-figure experiment harness: declarative policy x seed sweeps.

Public surface:
  SweepSpec / SweepCell -- declarative grids over the Sec.-VI comparison
                           axes (policies, datasets, N/K, scenarios,
                           server aggregation, seeds), expanded to
                           `SimConfig` cells with stable artifact ids;
  run_sweep / SweepResult -- dispatch a spec through the port's scan and
                           async engines (flat and hierarchical) and
                           derive the paper metrics;
  metrics                -- rounds/time-to-target-loss, sub-channel
                           utilization, cumulative latency;
  store                  -- versioned JSON artifacts under ``results/``;
  figures / render_gallery -- SVG convergence curves, utilization bars,
                           latency CDFs, and the sync-vs-async
                           time-to-target comparison, rendered from
                           artifacts.

The port of the JAX package's `experiments`, with the same public
surface; ``examples/torch_reproduce_figures.py`` is its end-to-end entry
point (DESIGN.md §10, §12).
"""
from .metrics import (
    cumulative_latency_s,
    eval_spacing_weights,
    mean_subchannel_utilization,
    per_round_utilization,
    rounds_to_target,
    summarize_cell,
    time_to_target_s,
)
from .figures import (
    AGG_COLORS,
    Facet,
    POLICY_COLORS,
    POLICY_NAMES,
    facets,
    fig_time_to_target,
    render_gallery,
    render_service_gallery,
)
from .runner import SweepResult, group_mean_curves, run_sweep
from .spec import SweepCell, SweepSpec
from .store import latest_dir, load_latest, load_record, write_record

__all__ = [
    "SweepSpec",
    "SweepCell",
    "SweepResult",
    "run_sweep",
    "group_mean_curves",
    "rounds_to_target",
    "time_to_target_s",
    "mean_subchannel_utilization",
    "per_round_utilization",
    "eval_spacing_weights",
    "cumulative_latency_s",
    "summarize_cell",
    "latest_dir",
    "load_latest",
    "load_record",
    "write_record",
    "POLICY_COLORS",
    "POLICY_NAMES",
    "AGG_COLORS",
    "Facet",
    "facets",
    "render_gallery",
    "render_service_gallery",
    "fig_time_to_target",
]
