"""Sweep execution: expand a `SweepSpec`, dispatch its cells through the
port's engines, derive paper metrics, and persist a versioned artifact.

`run_sweep` is a thin deterministic shell around `fl.run_many` (flat cells)
and `fl.run_hier_many` (hierarchical cells): world and Γ sharing across
policy-only variants, and one model and trainer per same-shape group, live
in the engines (DESIGN.md §10).  The runner's own contract is that cell
results are IDENTICAL to solo `run_simulation` / `run_hierarchical` calls
(pinned by tests/test_torch_experiments.py), so an artifact is exactly
"the paper run N times".

The port of the JAX package's `experiments/runner.py`.  The port's engines
run a group's cells one at a time and have no `shard` argument (batching
and sharding are ROADMAP.md Queue 1), nor a choice of projection backend:
Γ is solved by kernel K1 on the card and by its plain version on the CPU.
"""
from __future__ import annotations

import dataclasses
import platform
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..fl.hierarchical import HierSimConfig, run_hier_many
from ..fl.sim import SimHistory, run_many
from ..scenarios import scenario_name
from .metrics import per_round_utilization, summarize_cell
from .spec import SweepCell, SweepSpec
from .store import next_version_dir, write_record

__all__ = ["SweepResult", "run_sweep"]


@dataclasses.dataclass
class SweepResult:
    """A finished sweep: the JSON-ready record plus in-memory histories."""

    spec: SweepSpec
    record: dict
    histories: list[SimHistory]
    cells: list[SweepCell]
    out_dir: Path | None = None

    def cell(self, cell_id: str) -> dict:
        for c in self.record["cells"]:
            if c["id"] == cell_id:
                return c
        raise KeyError(cell_id)


def _cell_record(cell: SweepCell, hist: SimHistory,
                 target_loss: float | None) -> dict:
    cfg = cell.config
    lat_all = (hist.latency_all if hist.latency_all is not None
               else hist.latency_s)
    util = per_round_utilization(hist, cfg.n_subchannels)
    g_agg = getattr(cfg, "global_aggregation", "sync")
    return {
        "id": cell.cell_id,
        "dataset": cfg.dataset,
        "n_devices": cfg.n_devices,
        "n_subchannels": cfg.n_subchannels,
        "n_cells": getattr(cfg, "n_cells", 1),
        "scenario": scenario_name(cfg.scenario),
        "aggregation": (cfg.aggregation if isinstance(cfg.aggregation, str)
                        else "custom"),
        "global_aggregation": g_agg if isinstance(g_agg, str) else "custom",
        "seed": cfg.seed,
        "policy": {"ds": cfg.policy.ds, "ra": cfg.policy.ra,
                   "sa": cfg.policy.sa, "label": cfg.policy.label},
        "metrics": summarize_cell(cfg, hist, target_loss),
        "curves": {
            "round": [int(r) for r in hist.rounds],
            "global_loss": [float(v) for v in hist.global_loss],
            "accuracy": [float(v) for v in hist.accuracy],
            "cum_time_s": [float(v) for v in hist.cum_time_s],
        },
        "trace": {
            "latency_s": [float(v) for v in lat_all],
            "utilization": [float(v) for v in util],
        },
    }


def _env(device: torch.device) -> dict:
    """Where the sweep ran: the host, the torch device and its name, and
    the CUDA devices visible."""
    return {
        "host": platform.machine(),
        "torch_device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "cuda_devices": torch.cuda.device_count(),
    }


def run_sweep(spec: SweepSpec, *,
              engine: str = "scan",
              device=None,
              results_root: str | Path = "results",
              write: bool = True,
              figures: bool = False) -> SweepResult:
    """Run every cell of `spec` and (optionally) persist the artifact.

    Args:
      spec: the declarative grid to run.
      engine: `fl.run_many` round-loop engine: "scan" (default), "async"
        or "loop".  Hierarchical cells run on `fl.run_hier_many`'s "scan"
        (or "async" when engine="async"); engine="loop" refuses them.
      device: "cuda[:i]" or "cpu"; None means the current CUDA device and
        raises when none is visible.
      results_root: artifact root; each call writes a NEW
        ``<root>/<spec.name>/v####/`` version (see `experiments.store`).
      write: set False to skip artifact I/O (returns the record in memory).
      figures: also render the SVG gallery into ``<version>/figures/``.

    Returns a `SweepResult`; ``result.record`` is the JSON artifact.
    """
    device = resolve_device(device)
    cells = spec.cells()
    # Flat and hierarchical cells dispatch through their own engines
    # (run_many / run_hier_many — identical grouping disciplines), then
    # reassemble in expansion order.
    flat_idx = [i for i, c in enumerate(cells)
                if not isinstance(c.config, HierSimConfig)]
    hier_idx = [i for i, c in enumerate(cells)
                if isinstance(c.config, HierSimConfig)]
    if hier_idx and engine == "loop":
        raise ValueError(
            "engine='loop' cannot run hierarchical sweep cells — "
            "use 'scan' or 'async'")
    t0 = time.time()
    hists: list[SimHistory | None] = [None] * len(cells)
    if flat_idx:
        for i, h in zip(flat_idx, run_many(
                [cells[i].config for i in flat_idx], engine=engine,
                device=device)):
            hists[i] = h
    if hier_idx:
        hier_engine = "async" if engine == "async" else "scan"
        for i, h in zip(hier_idx, run_hier_many(
                [cells[i].config for i in hier_idx], engine=hier_engine,
                device=device)):
            hists[i] = h
    wall_s = time.time() - t0

    record = {
        "schema": 1,
        "sweep": spec.to_json(),
        "engine": engine,
        "n_cells": len(cells),
        "wall_s": wall_s,
        "env": _env(device),
        "cells": [_cell_record(c, h, spec.target_loss)
                  for c, h in zip(cells, hists)],
    }

    result = SweepResult(spec=spec, record=record, histories=list(hists),
                         cells=cells)
    if write:
        out_dir = next_version_dir(results_root, spec.name)
        write_record(record, out_dir)
        result.out_dir = out_dir
        if figures:
            from .figures import render_gallery
            render_gallery(record, out_dir / "figures")
    return result


def group_mean_curves(record: dict, *, dataset: str | None = None,
                      n_devices: int | None = None,
                      n_subchannels: int | None = None,
                      scenario: str | None = None,
                      aggregation: str | None = None,
                      n_cells: int | None = None,
                      global_aggregation: str | None = None,
                      key: str = "global_loss") -> dict[str, tuple]:
    """Average a per-cell eval curve over SEEDS, per policy label.

    Returns {policy_label: (rounds, mean_curve)} for cells matching the
    given dataset / N / K / scenario / aggregation / topology (each None
    = the record's only value; raises if the record varies an unfiltered
    axis, so heterogeneous configs are never silently pooled into one
    curve).  The label is the full ds+ra+sa scheme name, so distinct
    policies never merge either.
    """
    cells = record["cells"]

    def resolve(name, value, getter):
        values = sorted({getter(c) for c in cells})
        if value is None:
            if len(values) > 1:
                raise ValueError(
                    f"record spans {name}={values}; pass {name}= to pick one")
            return values[0]
        return value

    dataset = resolve("dataset", dataset, lambda c: c["dataset"])
    n_devices = resolve("n_devices", n_devices, lambda c: c["n_devices"])
    n_subchannels = resolve("n_subchannels", n_subchannels,
                            lambda c: c["n_subchannels"])
    scenario = resolve("scenario", scenario,
                       lambda c: c.get("scenario", "static"))
    aggregation = resolve("aggregation", aggregation,
                          lambda c: c.get("aggregation", "sync"))
    n_cells = resolve("n_cells", n_cells, lambda c: c.get("n_cells", 1))
    global_aggregation = resolve(
        "global_aggregation", global_aggregation,
        lambda c: c.get("global_aggregation", "sync"))
    by_label: dict[str, list] = {}
    rounds_by_label: dict[str, Sequence[int]] = {}
    for c in cells:
        if (c["dataset"], c["n_devices"], c["n_subchannels"],
                c.get("scenario", "static"),
                c.get("aggregation", "sync"),
                c.get("n_cells", 1),
                c.get("global_aggregation", "sync")) != (
                dataset, n_devices, n_subchannels, scenario, aggregation,
                n_cells, global_aggregation):
            continue
        lab = c["policy"]["label"]
        by_label.setdefault(lab, []).append(c["curves"][key])
        rounds_by_label[lab] = c["curves"]["round"]
    return {lab: (rounds_by_label[lab],
                  np.mean(np.asarray(v, float), axis=0))
            for lab, v in by_label.items()}
