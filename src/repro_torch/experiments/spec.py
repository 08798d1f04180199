"""Declarative sweep specifications over the simulation grid.

A `SweepSpec` names a Cartesian grid over the paper's comparison axes —
device-selection / resource-allocation / sub-channel-assignment schemes
(Sec. VI policies), datasets, network sizes (N, K), environment scenarios
(`repro.scenarios` presets), and seeds — and expands it into concrete
`SimConfig` cells with stable, path-safe ids.  The expansion order is
fixed (dataset-major, then (N, K), then scenario, then the
`core.policy_grid` policy order, then seed) so cell ids and artifact
layouts are reproducible across runs and machines.

The spec is deliberately *declarative*: it never runs anything.  The
runner (`repro_torch.experiments.runner`) feeds the expanded cells through
`fl.run_many(engine="scan")` and `fl.run_hier_many`, which share worlds and
Γ solves across policy-only variants (DESIGN.md §10).  A copy of the JAX
package's `experiments/spec.py` over the port's configs: the same spec
expands to the same cell ids, order and configs.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Sequence

from ..core.stackelberg import RoundPolicy, policy_grid
from ..fl.hierarchical import HierSimConfig
from ..fl.server import get_aggregation
from ..fl.sim import SimConfig
from ..scenarios import Scenario, get_scenario

__all__ = ["SweepSpec", "SweepCell"]

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")

# Config fields a spec may override beyond the grid axes, per cell kind:
# flat cells expand to `SimConfig`, hierarchical cells (cell_counts > 1 or
# an async global tier) to `HierSimConfig`.  A mixed grid may only
# override the intersection.
_AXIS_FIELDS = ("dataset", "n_devices", "n_subchannels", "seed", "policy",
                "rounds", "scenario", "aggregation")
_OVERRIDABLE = frozenset(
    f.name for f in dataclasses.fields(SimConfig)
    if f.name not in _AXIS_FIELDS)
_HIER_OVERRIDABLE = frozenset(
    f.name for f in dataclasses.fields(HierSimConfig)
    if f.name not in _AXIS_FIELDS + (
        "n_cells", "devices_per_cell", "subchannels_per_cell",
        "global_aggregation"))


def _axis(v) -> tuple:
    """Normalize a grid axis: scalars become 1-tuples, sequences tuples."""
    if isinstance(v, (str, int, float)) or v is None:
        return (v,)
    return tuple(v)


@dataclasses.dataclass(frozen=True)
class SweepCell:
    """One expanded grid point: a stable id plus its concrete `SimConfig`."""

    cell_id: str
    index: int
    config: SimConfig | HierSimConfig


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A named Cartesian grid over the paper's comparison axes.

    Args:
      name: artifact-directory name (``results/<name>/v####/``); must be
        path-safe (letters, digits, ``._-``).
      datasets: Table-I dataset names ("mnist" / "cifar10" / "sst2").
      ds / ra / sa: policy scheme axes, crossed via `core.policy_grid`
        (eq. 42-43 selection, Algorithm-1 vs FIX RA, Algorithm-2 vs R-SA).
      n_devices / n_subchannels: network-size axes (N, K), crossed.
      scenarios: environment-scenario axis, by preset/registered name
        (`repro_torch.scenarios.PRESETS`; "static" = the paper's fixed world).
        Scenarios vary only trace data, never program shape, so a
        policy x scenario x seed grid shares one model and trainer per
        shape (DESIGN.md §11).
      aggregation: server-aggregation axis, by preset name ("sync" =
        the paper's eq.-34 round barrier; "async" / "async_const" /
        "async_full" = the buffered staleness-weighted event engine,
        `fl.AGGREGATION_PRESETS`, DESIGN.md §12).  Async cells route
        through `engine="async"` automatically and SHARE the sync cells'
        sampled worlds and Γ solves, so the comparison is differential.
      cell_counts: hierarchical-topology axis: how many base-station
        cells split the N devices / K sub-channels (each must divide
        both).  1 = the flat single-server network (`SimConfig`); > 1
        expands to a `HierSimConfig` city (N/cells devices and K/cells
        sub-channels per cell) routed through `fl.run_hier_many`
        (DESIGN.md §15).
      global_aggregation: the GLOBAL tier's commit discipline for
        hierarchical cells, by preset name ("sync" = the two-tier
        round barrier; async presets = the buffered staleness-weighted
        global server).  A non-"sync" value makes the cell hierarchical
        even at cell_counts=1.
      seeds: world seeds; cells differing only in policy or aggregation
        share one sampled world and one Γ solve (`fl.run_many` dedups
        them).
      rounds: communication rounds per cell (scalar — part of a group's
        shape, so it is not a grid axis).
      target_loss: global-loss threshold used by the derived
        rounds-to-target / time-to-target metrics (None disables them).
      overrides: extra `SimConfig` fields applied to every cell, as a
        mapping or ``((field, value), ...)`` pairs — e.g.
        ``{"n_samples": 256, "eval_every": 5}``.
    """

    name: str
    datasets: Sequence[str] = ("mnist",)
    ds: Sequence[str] = ("alg3",)
    ra: Sequence[str] = ("mo",)
    sa: Sequence[str] = ("matching",)
    n_devices: Sequence[int] = (20,)
    n_subchannels: Sequence[int] = (4,)
    scenarios: Sequence[str] = ("static",)
    aggregation: Sequence[str] = ("sync",)
    cell_counts: Sequence[int] = (1,)
    global_aggregation: Sequence[str] = ("sync",)
    seeds: Sequence[int] = (0,)
    rounds: int = 100
    target_loss: float | None = None
    overrides: Any = ()

    def __post_init__(self):
        if not _NAME_RE.match(self.name):
            raise ValueError(f"sweep name not path-safe: {self.name!r}")
        # Scenario objects are welcome but normalize to their registry NAME
        # (specs must stay JSON-serializable and reproducible by name) —
        # and only if the registry entry IS that object's configuration;
        # silently substituting a same-named preset would mislabel the
        # artifact.
        def norm(s):
            if not isinstance(s, Scenario):
                return s
            try:
                registered = get_scenario(s.name)
            except ValueError:
                raise ValueError(
                    f"scenario object {s.name!r} is not registered — "
                    f"register_scenario(...) it first so the spec stays "
                    f"reproducible by name") from None
            if registered != s:
                raise ValueError(
                    f"scenario object {s.name!r} differs from the "
                    f"registered preset of that name — register it under "
                    f"a distinct name")
            return s.name

        sc_axis = self.scenarios
        if isinstance(sc_axis, (str, Scenario)):
            sc_axis = (sc_axis,)
        object.__setattr__(self, "scenarios",
                           tuple(norm(s) for s in sc_axis))
        for field in ("datasets", "ds", "ra", "sa", "n_devices",
                      "n_subchannels", "scenarios", "aggregation",
                      "cell_counts", "global_aggregation", "seeds"):
            object.__setattr__(self, field, _axis(getattr(self, field)))
        for sc in self.scenarios:   # validate eagerly: known AND path-safe
            get_scenario(sc)        # (names flow into cell ids + filenames)
            if not _NAME_RE.match(sc):
                raise ValueError(f"scenario name not path-safe: {sc!r}")
        for axis in ("aggregation", "global_aggregation"):
            for agg in getattr(self, axis):  # presets only: JSON-safe specs
                if not isinstance(agg, str):
                    raise ValueError(
                        f"{axis} axis values must be preset names, got "
                        f"{agg!r} — register custom AsyncAggregation specs "
                        f"via fl.AGGREGATION_PRESETS")
                get_aggregation(agg)
                if not _NAME_RE.match(agg):
                    raise ValueError(f"{axis} name not path-safe: {agg!r}")
        for nc in self.cell_counts:
            if not isinstance(nc, int) or nc < 1:
                raise ValueError(f"cell_counts must be positive ints, "
                                 f"got {nc!r}")
            for n in self.n_devices:
                if n % nc:
                    raise ValueError(
                        f"cell_counts={nc} does not divide n_devices={n}")
            for k in self.n_subchannels:
                if k % nc:
                    raise ValueError(
                        f"cell_counts={nc} does not divide n_subchannels={k}")
        ov = self.overrides
        ov = tuple(sorted(ov.items())) if isinstance(ov, dict) else tuple(
            (str(k), v) for k, v in ov)
        # Validate overrides against every cell KIND the grid expands to.
        allowed: frozenset = frozenset(_OVERRIDABLE | _HIER_OVERRIDABLE)
        if any(self._is_hier(nc, g) for nc in self.cell_counts
               for g in self.global_aggregation):
            allowed &= _HIER_OVERRIDABLE
        if any(not self._is_hier(nc, g) for nc in self.cell_counts
               for g in self.global_aggregation):
            allowed &= _OVERRIDABLE
        unknown = [k for k, _ in ov if k not in allowed]
        if unknown:
            raise ValueError(
                f"overrides reference fields unknown to (or not "
                f"overridable on) every cell kind in this grid: {unknown} "
                f"(allowed here: {sorted(allowed)})")
        object.__setattr__(self, "overrides", ov)
        self.policies  # validate scheme names eagerly

    @property
    def policies(self) -> list[RoundPolicy]:
        """The policy axis expanded in `core.policy_grid` order."""
        return policy_grid(ds=tuple(self.ds), ra=tuple(self.ra),
                           sa=tuple(self.sa))

    @staticmethod
    def _is_hier(n_cells: int, global_aggregation: str) -> bool:
        """A grid point is hierarchical iff it has more than one cell or
        a non-trivial global commit tier (a cells-of-one hierarchy with a
        sync global tier IS the flat network — tests pin it bit-exact —
        so it expands to the flat `SimConfig` and keeps flat cell ids)."""
        return n_cells > 1 or global_aggregation != "sync"

    @property
    def n_cells(self) -> int:
        return (len(self.datasets) * len(self.n_devices)
                * len(self.n_subchannels) * len(self.scenarios)
                * len(self.aggregation) * len(self.cell_counts)
                * len(self.global_aggregation) * len(self.policies)
                * len(self.seeds))

    def cells(self) -> list[SweepCell]:
        """Expand the grid: dataset > (N, K) > topology > scenario >
        aggregation > global aggregation > policy > seed.

        Ids are stable; the topology, scenario, and aggregation segments
        are omitted for 1 / "static" / "sync" / "sync" so pre-existing
        sweep ids (and committed artifacts) stay unchanged.
        """
        out: list[SweepCell] = []
        ov = dict(self.overrides)
        hier_ov = {k: v for k, v in ov.items() if k in _HIER_OVERRIDABLE}
        for dataset in self.datasets:
          for n in self.n_devices:
            for k in self.n_subchannels:
              for nc in self.cell_counts:
                c_part = "" if nc == 1 else f"-C{nc}"
                for sc in self.scenarios:
                    sc_part = "" if sc == "static" else f"-{sc}"
                    for agg in self.aggregation:
                        agg_part = "" if agg == "sync" else f"-{agg}"
                        for g_agg in self.global_aggregation:
                            g_part = "" if g_agg == "sync" else f"-g.{g_agg}"
                            for pol in self.policies:
                                for seed in self.seeds:
                                    if self._is_hier(nc, g_agg):
                                        cfg = HierSimConfig(
                                            dataset=dataset, n_cells=nc,
                                            devices_per_cell=n // nc,
                                            subchannels_per_cell=k // nc,
                                            rounds=self.rounds, policy=pol,
                                            seed=seed, scenario=sc,
                                            aggregation=agg,
                                            global_aggregation=g_agg,
                                            **hier_ov)
                                    else:
                                        cfg = SimConfig(
                                            dataset=dataset, n_devices=n,
                                            n_subchannels=k,
                                            rounds=self.rounds,
                                            policy=pol, seed=seed,
                                            scenario=sc, aggregation=agg,
                                            **ov)
                                    cid = (f"{dataset}-N{n}-K{k}{c_part}"
                                           f"{sc_part}{agg_part}{g_part}-"
                                           f"{pol.ds}.{pol.ra}.{pol.sa}"
                                           f"-s{seed}")
                                    out.append(SweepCell(cid, len(out), cfg))
        return out

    def to_json(self) -> dict:
        """JSON-serializable form (round-trips through `from_json`)."""
        d = dataclasses.asdict(self)
        d["overrides"] = dict(self.overrides)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "SweepSpec":
        return cls(**d)
