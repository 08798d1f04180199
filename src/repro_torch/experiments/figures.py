"""Paper-figure renderers over sweep artifacts (no matplotlib required).

Reads the versioned ``sweep.json`` record (never live histories), so every
figure in the gallery can be regenerated from a committed artifact alone:

  * convergence curves — global loss vs round and vs simulated time
    (Fig. 3 / Fig. 5 style), seed-averaged per device-selection policy;
  * sub-channel utilization bars — mean fraction of the K uplink slots
    used per round (the Fig. 7 resource story);
  * per-round latency CDF — the eq.-9 latency distribution each policy
    induces (the denominator of convergence *time*).

Cells are FACETED before averaging: one figure set per distinct
(dataset, N, K, ra, sa) combination, so a sweep that crosses resource
allocation, assignment, or network-size axes renders small multiples
instead of silently pooling heterogeneous configs into one curve.  Only
seeds are averaged within a series.

Colors follow the policy ENTITY, never its rank: each ds scheme owns a
fixed slot of the validated categorical palette (order blue, orange, aqua,
yellow, magenta — adjacent-pair CVD-safe; see the dataviz palette notes),
so adding or filtering policies never repaints the survivors.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from .svg import Series, bar_chart, line_chart

__all__ = ["POLICY_COLORS", "POLICY_NAMES", "AGG_COLORS", "Facet", "facets",
           "render_gallery", "fig_convergence", "fig_utilization",
           "fig_latency_cdf", "fig_time_to_target",
           "fig_service_latency_cdf", "fig_service_steady_state",
           "fig_service_occupancy", "render_service_gallery"]

# Fixed entity -> categorical-slot assignment (light-mode steps).
POLICY_COLORS = {
    "alg3": "#2a78d6",      # slot 1, blue   — the proposed scheme
    "random": "#eb6834",    # slot 2, orange
    "fixed": "#1baf7a",     # slot 3, aqua
    "cluster": "#eda100",   # slot 4, yellow
    "aou_topk": "#e87ba4",  # slot 5, magenta
}
POLICY_NAMES = {
    "alg3": "Alg. 3 (proposed)",
    "random": "Random DS",
    "fixed": "Fixed DS",
    "cluster": "Cluster DS",
    "aou_topk": "AoU top-K DS",
}
# Stable legend/bar order: proposed first, then the Sec.-VI baselines.
_DS_ORDER = list(POLICY_COLORS)

# Server-aggregation entity colors (DESIGN.md §12): the paper's sync
# barrier keeps the proposed-scheme blue; async commit policies own fixed
# slots of the same categorical palette.
AGG_COLORS = {
    "sync": "#2a78d6",        # slot 1, blue   — eq.-34 round barrier
    "async": "#eb6834",       # slot 2, orange — buffered, poly staleness
    "async_const": "#eda100", # slot 4, yellow — buffered, constant weights
    "async_full": "#1baf7a",  # slot 3, aqua   — full barrier (sync limit)
}


@dataclasses.dataclass(frozen=True)
class Facet:
    """One homogeneous slice of a record: everything but ds scheme and
    seed is fixed, so seed-averaging within it is meaningful.  Scenario
    and aggregation are facet keys — pooling different environments or
    server disciplines into one curve would fabricate a run that was
    never simulated."""

    dataset: str
    n_devices: int
    n_subchannels: int
    ra: str
    sa: str
    scenario: str
    aggregation: str
    n_cells: int
    global_aggregation: str
    suffix: str    # filename suffix ("mnist", "mnist-urban-async", ...)

    def matches(self, cell: dict) -> bool:
        return (cell["dataset"] == self.dataset
                and cell["n_devices"] == self.n_devices
                and cell["n_subchannels"] == self.n_subchannels
                and cell["policy"]["ra"] == self.ra
                and cell["policy"]["sa"] == self.sa
                and cell.get("scenario", "static") == self.scenario
                and cell.get("aggregation", "sync") == self.aggregation
                and cell.get("n_cells", 1) == self.n_cells
                and cell.get("global_aggregation", "sync")
                == self.global_aggregation)


def facets(record: dict) -> list[Facet]:
    """Distinct (dataset, N, K, ra, sa, scenario, aggregation, topology)
    slices, with minimal suffixes: shape/scheme/scenario/aggregation/
    cell-count parts appear only when the record actually varies them.
    (Older artifacts carry no "scenario"/"aggregation"/"n_cells" keys;
    those cells facet as static/sync/flat.)"""
    keys = sorted({(c["dataset"], c["n_devices"], c["n_subchannels"],
                    c["policy"]["ra"], c["policy"]["sa"],
                    c.get("scenario", "static"),
                    c.get("aggregation", "sync"),
                    c.get("n_cells", 1),
                    c.get("global_aggregation", "sync"))
                   for c in record["cells"]})
    many_shapes = len({(d, n, k) for d, n, k, *_ in keys}) > len(
        {d for d, *_ in keys})
    many_schemes = len({(r, s) for _, _, _, r, s, *_ in keys}) > 1
    many_scenarios = len({sc for *_, sc, _, _, _ in keys}) > 1
    many_aggs = len({ag for *_, ag, _, _ in keys}) > 1
    many_cells = len({nc for *_, nc, _ in keys}) > 1
    many_gaggs = len({g for *_, g in keys}) > 1
    out = []
    for d, n, k, r, s, sc, ag, nc, g in keys:
        suffix = d
        if many_shapes:
            suffix += f"-N{n}-K{k}"
        if many_schemes:
            suffix += f"-{r}.{s}"
        if many_cells:
            suffix += f"-C{nc}"
        if many_scenarios:
            suffix += f"-{sc}"
        if many_aggs:
            suffix += f"-{ag}"
        if many_gaggs:
            suffix += f"-g.{g}"
        out.append(Facet(d, n, k, r, s, sc, ag, nc, g, suffix))
    return out


def _by_ds(record: dict, facet: Facet) -> dict[str, list[dict]]:
    """The facet's cells grouped by ds scheme, in `_DS_ORDER`."""
    groups: dict[str, list[dict]] = {}
    for c in record["cells"]:
        if facet.matches(c):
            groups.setdefault(c["policy"]["ds"], []).append(c)
    return {ds: groups[ds] for ds in _DS_ORDER if ds in groups}


def _seed_mean(cells: list[dict], section: str, key: str) -> np.ndarray:
    return np.mean([np.asarray(c[section][key], float) for c in cells],
                   axis=0)


def fig_convergence(record: dict, facet: Facet, out_dir: Path,
                    x_axis: str = "round") -> Path:
    """Seed-averaged global-loss curves per policy (vs round or sim time)."""
    series = []
    for ds, cells in _by_ds(record, facet).items():
        y = _seed_mean(cells, "curves", "global_loss")
        x = (np.asarray(cells[0]["curves"]["round"], float) if x_axis == "round"
             else _seed_mean(cells, "curves", "cum_time_s"))
        series.append(Series(POLICY_NAMES[ds], x, y, POLICY_COLORS[ds]))
    xlabel = ("communication round" if x_axis == "round"
              else "simulated time (s, eq. 9 cumulative)")
    suffix = "rounds" if x_axis == "round" else "time"
    return line_chart(
        series, out_dir / f"convergence_{suffix}_{facet.suffix}.svg",
        title=f"Global loss vs {xlabel.split(' (')[0]} — {facet.suffix}",
        xlabel=xlabel, ylabel="global loss F(w)")


def fig_utilization(record: dict, facet: Facet, out_dir: Path) -> Path:
    """Mean sub-channel utilization per policy (seed-averaged)."""
    labels, values, colors = [], [], []
    for ds, cells in _by_ds(record, facet).items():
        labels.append(POLICY_NAMES[ds])
        values.append(float(np.mean(
            [c["metrics"]["mean_subchannel_utilization"] for c in cells])))
        colors.append(POLICY_COLORS[ds])
    return bar_chart(
        labels, values, colors, out_dir / f"utilization_{facet.suffix}.svg",
        title=f"Mean sub-channel utilization — {facet.suffix}",
        ylabel="fraction of K sub-channels used",
        value_fmt=lambda v: f"{v:.2f}")


def fig_latency_cdf(record: dict, facet: Facet, out_dir: Path) -> Path:
    """Empirical CDF of per-round latency, pooled over rounds and seeds."""
    series = []
    for ds, cells in _by_ds(record, facet).items():
        lat = np.sort(np.concatenate(
            [np.asarray(c["trace"]["latency_s"], float) for c in cells]))
        cdf = np.arange(1, lat.size + 1) / lat.size
        series.append(Series(POLICY_NAMES[ds], lat, cdf,
                             POLICY_COLORS[ds], step=True))
    return line_chart(
        series, out_dir / f"latency_cdf_{facet.suffix}.svg",
        title=f"Per-round latency CDF — {facet.suffix}",
        xlabel="round latency (s, eq. 9)",
        ylabel="P(latency ≤ x)", ylim=(0.0, 1.04))


def fig_time_to_target(record: dict, out_dir: Path,
                       ds: str | None = None) -> Path | None:
    """Simulated time-to-target per (scenario, aggregation) — the async
    engine's headline comparison (DESIGN.md §12): how fast each server
    discipline reaches the target loss in eq.-9 simulated seconds, per
    environment.  Bars are seed-averaged for ONE ds scheme (the proposed
    Algorithm 3 when present); a (scenario, aggregation) group where any
    seed misses the target renders no bar.  Returns None when the record
    fixes the aggregation axis, carries no time-to-target metric, or
    still varies dataset / N / K / ra / sa within the chosen ds — the
    no-pooling invariant of `Facet` applies here too: only seeds are
    ever averaged into a bar.
    """
    cells = record["cells"]
    aggs = sorted({(c.get("aggregation", "sync"),
                    c.get("global_aggregation", "sync")) for c in cells})
    if len(aggs) < 2:
        return None
    if ds is None:
        present = {c["policy"]["ds"] for c in cells}
        ds = "alg3" if "alg3" in present else sorted(present)[0]
    slices = {(c["dataset"], c["n_devices"], c["n_subchannels"],
               c.get("n_cells", 1), c["policy"]["ra"], c["policy"]["sa"])
              for c in cells if c["policy"]["ds"] == ds}
    if len(slices) != 1:
        return None    # heterogeneous configs: refuse, never pool
    many_gaggs = len({g for _, g in aggs}) > 1
    groups: dict[tuple[str, str, str], list] = {}
    for c in cells:
        if c["policy"]["ds"] != ds:
            continue
        key = (c.get("scenario", "static"), c.get("aggregation", "sync"),
               c.get("global_aggregation", "sync"))
        groups.setdefault(key, []).append(
            c["metrics"].get("time_to_target_s"))
    scenarios = sorted({sc for sc, _, _ in groups})
    flat_aggs = sorted({a for a, _ in aggs})
    agg_order = [a for a in AGG_COLORS if a in flat_aggs] + [
        a for a in flat_aggs if a not in AGG_COLORS]
    g_order = sorted({g for _, g in aggs})
    labels, values, colors = [], [], []
    for sc in scenarios:
        for ag in agg_order:
            for g in g_order:
                ts = groups.get((sc, ag, g))
                if not ts or any(t is None for t in ts):
                    continue
                lab = f"{sc} · {ag}"
                if many_gaggs:
                    lab += f"/g.{g}"
                labels.append(lab)
                values.append(float(np.mean(ts)))
                colors.append(AGG_COLORS.get(ag, "#8a8f98"))
    if not values:
        return None
    return bar_chart(
        labels, values, colors, out_dir / f"time_to_target_{ds}.svg",
        title=f"Simulated time to target loss — {ds}, sync vs async",
        ylabel="time to target (s, eq. 9 cumulative)",
        value_fmt=lambda v: f"{v:.1f}")


_SERVICE_COLOR = AGG_COLORS["async"]   # the service IS the async engine
_BUDGET_COLOR = "#8a8f98"              # neutral context line, never a series


def fig_service_latency_cdf(record: dict, out_dir: Path) -> Path:
    """Empirical CDF of per-event wall commit latency from a
    ``service.json`` record, with the SLO budget as a vertical context
    line — the attained fraction is where the CDF crosses it."""
    lat = np.sort(np.asarray(record["events"]["latency_s"], float))
    cdf = np.arange(1, lat.size + 1) / lat.size
    budget = float(record["summary"]["slo"]["budget_s"])
    series = [Series("commit latency", lat, cdf, _SERVICE_COLOR, step=True)]
    if lat.min() <= budget <= lat.max() * 1.5:
        series.append(Series(f"SLO budget ({budget:g}s)",
                             np.array([budget, budget]),
                             np.array([0.0, 1.0]), _BUDGET_COLOR))
    return line_chart(
        series, Path(out_dir) / "service_latency_cdf.svg",
        title="Sustained service — commit latency CDF",
        xlabel="per-event commit latency (s, wall)",
        ylabel="P(latency ≤ x)", ylim=(0.0, 1.04))


def fig_service_steady_state(record: dict, out_dir: Path) -> Path:
    """Steady-state global loss vs events served under continuous churn."""
    ss = record["steady_state"]
    x = np.asarray(ss["event"], float)
    return line_chart(
        [Series("global loss", x, np.asarray(ss["global_loss"], float),
                _SERVICE_COLOR)],
        Path(out_dir) / "service_steady_state.svg",
        title="Sustained service — steady-state loss",
        xlabel="events served (cumulative, incl. warm-up)",
        ylabel="global loss F(w)")


def fig_service_occupancy(record: dict, out_dir: Path) -> Path:
    """Server buffer occupancy and mean device AoU per measured event."""
    ev = record["events"]
    x = np.asarray(ev["event"], float)
    series = [Series("buffer occupancy", x,
                     np.asarray(ev["n_pending"], float),
                     _SERVICE_COLOR, step=True)]
    if "mean_age" in ev:
        series.append(Series("mean AoU (rounds)", x,
                             np.asarray(ev["mean_age"], float),
                             AGG_COLORS["async_const"]))
    return line_chart(
        series, Path(out_dir) / "service_occupancy.svg",
        title="Sustained service — buffer occupancy / AoU",
        xlabel="events served (cumulative, incl. warm-up)",
        ylabel="pending updates / mean AoU")


def render_service_gallery(record: dict, out_dir: str | Path) -> list[Path]:
    """All figures for one sustained-service record; returns written paths."""
    out_dir = Path(out_dir)
    return [fig_service_latency_cdf(record, out_dir),
            fig_service_steady_state(record, out_dir),
            fig_service_occupancy(record, out_dir)]


def render_gallery(record: dict, out_dir: str | Path) -> list[Path]:
    """All figures for every facet of a record; returns written paths."""
    out_dir = Path(out_dir)
    paths = []
    for facet in facets(record):
        paths.append(fig_convergence(record, facet, out_dir, "round"))
        paths.append(fig_convergence(record, facet, out_dir, "time"))
        paths.append(fig_utilization(record, facet, out_dir))
        paths.append(fig_latency_cdf(record, facet, out_dir))
    t2t = fig_time_to_target(record, out_dir)
    if t2t is not None:
        paths.append(t2t)
    return paths
