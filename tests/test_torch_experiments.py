"""The port's sweep harness (`repro_torch.experiments`) and the Prop-3
bound (`repro_torch.core.convergence`) on the CPU, against the JAX package.

  * the bound and the participation deficit bitwise equal to the JAX
    package's on seeded inputs, with the same refusals;
  * `SweepSpec`: the same cell ids, order, configs and `to_json()` as the
    JAX package's spec over a grid of ds x aggregation x cell_counts x
    scenarios, and the same bad specs refused;
  * `run_sweep(write=False)` over 2 policies x (sync, async) x
    cell_counts (1, 2) against the JAX package's `run_sweep(engine="scan",
    ra_backend="bisect")` with the JAX draws injected: the record's keys
    equal, tx- and AoU-derived fields and utilisation exact, latency-
    derived fields within 1e-6 relative (both sides cast the same float64
    Γ to float32), losses within the port's mnist tolerance of
    tests/test_torch_sim.py (1e-4 relative; accuracy rtol 1e-4);
  * the runner's own contract: each sweep cell bitwise equal to a solo
    `run_simulation` / `run_hierarchical` of its config;
  * the gallery: SVG files byte-equal to the JAX package's from the same
    committed record (read only); `group_mean_curves` equal, and its
    refusal to pool;
  * the artifact store: versioning, schema refusal, a stale listing
    retried, concurrent claims unique.
"""
from _torch_oracle import inject_jax_draws, inject_jax_hier_draws, rel_err  # noqa: I001

import concurrent.futures as cf
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import convergence_bound as jax_convergence_bound
from repro.core import participation_deficit as jax_participation_deficit
from repro.experiments import SweepSpec as JaxSweepSpec
from repro.experiments import group_mean_curves as jax_group_mean_curves
from repro.experiments import render_gallery as jax_render_gallery
from repro.experiments import render_service_gallery as jax_render_service_gallery
from repro.experiments import run_sweep as jax_run_sweep
from repro_torch.core import convergence_bound, participation_deficit
from repro_torch.experiments import (SweepSpec, facets, group_mean_curves, load_latest,
                                     load_record, render_gallery, render_service_gallery,
                                     run_sweep)
from repro_torch.experiments import store
from repro_torch.experiments.store import latest_dir, next_version_dir, write_record
from repro_torch.fl import HierSimConfig, run_hierarchical, run_simulation

RESULTS = Path(__file__).resolve().parent.parent / "results"
# The run_sweep grid: N and K divide by both cell counts (1 and 2).
SWEEP = dict(name="t", datasets="mnist", ds=("alg3", "random"), aggregation=("sync", "async"),
             cell_counts=(1, 2), seeds=(0,), rounds=6, n_devices=8, n_subchannels=4,
             target_loss=2.2, overrides={"n_samples": 96, "batch": 16, "local_steps": 2,
                                         "eval_every": 2})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors (as the
    hierarchy's test files pin it): beside other test workers, torch's
    default oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# Proposition 3
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_convergence_bound_bitwise_jax(seed):
    rng = np.random.default_rng(seed)
    t, n = 40, 12
    beta = rng.integers(5, 60, n).astype(np.float64)
    tx = rng.uniform(size=(t, n)) < 0.4
    deficits = [participation_deficit(beta, row) for row in tx]
    assert deficits == [jax_participation_deficit(beta, row) for row in tx]
    gsq = rng.exponential(size=t) * 3.0
    kw = dict(mu=float(rng.uniform(0.05, 0.5)), lips=float(rng.uniform(1.0, 4.0)),
              rho=float(rng.uniform(0.5, 2.0)))
    got = convergence_bound(2.5, gsq, np.asarray(deficits), float(beta.sum()), **kw)
    want = jax_convergence_bound(2.5, gsq, np.asarray(deficits), float(beta.sum()), **kw)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mu,lips", [(2.0, 1.0), (0.0, 1.0), (-0.1, 1.0)])
def test_convergence_bound_refuses_like_jax(mu, lips):
    args = (1.0, np.ones(3), np.ones(3), 3.0)
    for fn in (convergence_bound, jax_convergence_bound):
        with pytest.raises(ValueError, match="need 0 < mu <= L"):
            fn(*args, mu=mu, lips=lips, rho=1.0)


# --------------------------------------------------------------------------
# SweepSpec
# --------------------------------------------------------------------------

GRIDS = {
    "flat": dict(ds=("alg3", "random", "fixed"), seeds=(0, 1), n_devices=(8, 12),
                 n_subchannels=4, rounds=5, overrides={"n_samples": 64}),
    "agg-cells": dict(ds=("alg3", "cluster"), aggregation=("sync", "async", "async_full"),
                      cell_counts=(1, 2), n_devices=8, n_subchannels=4, rounds=4,
                      overrides={"n_samples": 64, "eval_every": 2}),
    "scenarios": dict(ds=("alg3", "aou_topk"), ra=("mo", "fix"), sa=("matching", "random"),
                      scenarios=("static", "churn", "urban"), cell_counts=(1, 2),
                      global_aggregation=("sync", "async"), n_devices=12,
                      n_subchannels=4, rounds=3, seeds=(3,)),
    "hier-only": dict(ds="alg3", cell_counts=(2,), aggregation=("sync", "async"),
                      scenarios=("corr_fading", "harvest"), n_devices=12,
                      n_subchannels=4, overrides={"cell_coupling": 0.5}),
}


@pytest.mark.parametrize("grid", list(GRIDS), ids=list(GRIDS))
def test_spec_cells_equal_jax(grid):
    spec, jspec = SweepSpec(name="g", **GRIDS[grid]), JaxSweepSpec(name="g", **GRIDS[grid])
    cells, jcells = spec.cells(), jspec.cells()
    assert spec.n_cells == jspec.n_cells == len(cells) == len(jcells) > 0
    assert [c.cell_id for c in cells] == [c.cell_id for c in jcells]
    assert [c.index for c in cells] == list(range(len(cells)))
    for c, j in zip(cells, jcells):
        assert type(c.config).__name__ == type(j.config).__name__, c.cell_id
        got, want = dataclasses.asdict(c.config), dataclasses.asdict(j.config)
        assert list(got) == list(want), c.cell_id
        for field in want:
            assert got[field] == want[field], (c.cell_id, field)
    assert spec.to_json() == jspec.to_json()
    assert json.dumps(spec.to_json()) == json.dumps(jspec.to_json())
    assert SweepSpec.from_json(spec.to_json()) == spec


BAD_SPECS = {
    "name": dict(name="bad/name"),
    "axis-override": dict(overrides={"n_devices": 5}),
    "typo-override": dict(overrides={"typo_field": 1}),
    "scheme": dict(ds="unknown-scheme"),
    "aggregation": dict(aggregation="warp"),
    "aggregation-override": dict(overrides={"aggregation": "async"}),
    "scenario": dict(scenarios="nowhere"),
    "cells-divide-n": dict(cell_counts=(3,), n_devices=20, n_subchannels=3),
    "cells-divide-k": dict(cell_counts=(2,), n_devices=20, n_subchannels=3),
    "cells-positive": dict(cell_counts=(0,)),
    "flat-only-override": dict(cell_counts=(1, 2), overrides={"partition": "dirichlet"}),
    "hier-only-override": dict(overrides={"cell_coupling": 0.5}),
    "global-aggregation": dict(global_aggregation="warp"),
}


@pytest.mark.parametrize("kw", list(BAD_SPECS.values()), ids=list(BAD_SPECS))
def test_spec_rejects_what_jax_rejects(kw):
    kw = dict({"name": "t"}, **kw)
    with pytest.raises(ValueError):
        JaxSweepSpec(**kw)
    with pytest.raises(ValueError):
        SweepSpec(**kw)


# --------------------------------------------------------------------------
# run_sweep
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_sweep():
    return jax_run_sweep(JaxSweepSpec(**SWEEP), engine="scan", ra_backend="bisect",
                         write=False)


@pytest.fixture(scope="module")
def port_sweep():
    """The port's sweep of the same spec, with the JAX draws injected."""
    with pytest.MonkeyPatch.context() as mp:
        inject_jax_draws(mp)
        inject_jax_hier_draws(mp)
        return run_sweep(SweepSpec(**SWEEP), engine="scan", device="cpu", write=False)


def _keys(obj, prefix=""):
    """Every key path of a JSON record (list entries merged)."""
    if isinstance(obj, dict):
        return {p for k, v in obj.items() for p in _keys(v, f"{prefix}/{k}")} | {prefix}
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return set().union(*(_keys(v, prefix + "[]") for v in obj))
    return {prefix}


def test_sweep_record_matches_jax(jax_sweep, port_sweep):
    got, want = port_sweep.record, jax_sweep.record
    assert set(got) == set(want)
    assert set(got["env"]) == {"host", "torch_device", "device_name", "cuda_devices"}
    assert got["env"]["torch_device"] == "cpu"
    for name in ("schema", "sweep", "engine", "n_cells"):
        assert got[name] == want[name], name
    assert _keys(got["cells"]) == _keys(want["cells"])
    assert got["n_cells"] == 8
    assert {c["n_cells"] for c in got["cells"]} == {1, 2}
    assert {c["aggregation"] for c in got["cells"]} == {"sync", "async"}


@pytest.mark.parametrize("index", range(8))
def test_sweep_cell_matches_jax(jax_sweep, port_sweep, index):
    got, want = port_sweep.record["cells"][index], jax_sweep.record["cells"][index]
    for name in ("id", "dataset", "n_devices", "n_subchannels", "n_cells", "scenario",
                 "aggregation", "global_aggregation", "seed", "policy"):
        assert got[name] == want[name], name
    assert got["curves"]["round"] == want["curves"]["round"]
    assert got["trace"]["utilization"] == want["trace"]["utilization"]
    gm, wm = got["metrics"], want["metrics"]
    assert set(gm) == set(wm)
    assert gm["mean_subchannel_utilization"] == wm["mean_subchannel_utilization"]
    assert gm["target_loss"] == wm["target_loss"]
    assert gm["rounds_to_target"] == wm["rounds_to_target"]
    for name in ("cumulative_latency_s", "mean_round_latency_s", "total_energy_j"):
        assert rel_err(gm[name], wm[name]) < 1e-6, name
    if wm["time_to_target_s"] is None:
        assert gm["time_to_target_s"] is None
    else:
        assert rel_err(gm["time_to_target_s"], wm["time_to_target_s"]) < 1e-6
    assert rel_err(got["trace"]["latency_s"], want["trace"]["latency_s"]) < 1e-6
    assert rel_err(got["curves"]["cum_time_s"], want["curves"]["cum_time_s"]) < 1e-6
    assert rel_err(got["curves"]["global_loss"], want["curves"]["global_loss"]) < 1e-4
    assert rel_err(gm["final_loss"], wm["final_loss"]) < 1e-4
    np.testing.assert_allclose(got["curves"]["accuracy"], want["curves"]["accuracy"],
                               rtol=1e-4, atol=0)
    # tx- and AoU-derived traces of the in-memory histories, exactly.
    gh, wh = port_sweep.histories[index], jax_sweep.histories[index]
    for name in ("tx_trace", "age_trace", "n_selected", "n_transmitted", "rounds"):
        np.testing.assert_array_equal(getattr(gh, name), getattr(wh, name), err_msg=name)
    if wh.commit_trace is not None:
        np.testing.assert_array_equal(gh.commit_trace, wh.commit_trace)
    assert gh.tx_trace.any()


def _solo(cfg):
    """One config through the solo entry point a user calls, as the
    sweep history's (tx, age, loss, accuracy, latency) traces."""
    if isinstance(cfg, HierSimConfig):
        out = run_hierarchical(cfg, engine="scan", device="cpu")
        return dict(tx=out["tx"].reshape(cfg.rounds, -1), age=out["age"].reshape(cfg.rounds, -1),
                    loss=out["loss"], acc=out["accuracy"], lat=out["latency"],
                    energy=out["energy"], rounds=out["eval_rounds"])
    h = run_simulation(cfg, engine="scan", device="cpu")
    return dict(tx=h.tx_trace, age=h.age_trace, loss=h.global_loss, acc=h.accuracy,
                lat=h.latency_all, energy=h.energy_all, rounds=h.rounds)


def test_sweep_cells_bitwise_solo_runs():
    """The runner's own contract: a sweep cell is exactly the solo run of
    its config (no draws injected: the port's own)."""
    spec = SweepSpec(**dict(SWEEP, ds=("alg3",), scenarios=("static", "churn")))
    res = run_sweep(spec, device="cpu", write=False)
    assert len(res.cells) == 8
    for cell, h in zip(res.cells, res.histories):
        want = _solo(cell.config)
        got = dict(tx=h.tx_trace, age=h.age_trace, loss=h.global_loss, acc=h.accuracy,
                   lat=h.latency_all, energy=h.energy_all, rounds=h.rounds)
        for name, v in want.items():
            np.testing.assert_array_equal(got[name], v, err_msg=f"{cell.cell_id} {name}")


def test_sweep_refusals(tmp_path):
    spec = SweepSpec(**dict(SWEEP, ds="alg3", aggregation="sync", cell_counts=(2,)))
    with pytest.raises(ValueError, match="loop"):
        run_sweep(spec, engine="loop", device="cpu", write=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_sweep(spec, write=False)
    assert not any(tmp_path.iterdir())


def test_sweep_writes_a_version(tmp_path):
    spec = SweepSpec(**dict(SWEEP, ds="alg3", aggregation="sync", cell_counts=(1,),
                            rounds=2, overrides={"n_samples": 64, "batch": 16,
                                                 "local_steps": 1}))
    res = run_sweep(spec, device="cpu", results_root=tmp_path, figures=True)
    assert res.out_dir == tmp_path / "t" / "v0001"
    rec = load_record(res.out_dir)
    assert rec == json.loads(json.dumps(res.record))
    assert sorted(p.name for p in (res.out_dir / "figures").iterdir()) == [
        "convergence_rounds_mnist.svg", "convergence_time_mnist.svg",
        "latency_cdf_mnist.svg", "utilization_mnist.svg"]
    assert res.cell(res.cells[0].cell_id)["id"] == res.cells[0].cell_id


# --------------------------------------------------------------------------
# the gallery, from committed records (read only)
# --------------------------------------------------------------------------

def _committed(name: str, filename: str) -> dict:
    path = sorted((RESULTS / name).glob("v*/" + filename))[-1]
    return json.loads(path.read_text())


def _same_files(got: list[Path], want: list[Path]) -> None:
    assert [p.name for p in got] == [p.name for p in want]
    for g, w in zip(got, want):
        assert g.read_bytes() == w.read_bytes(), g.name


@pytest.mark.parametrize("name", ["fig3_convergence", "async_vs_sync", "hier_async"])
def test_gallery_svg_bytes_equal_jax(tmp_path, name):
    rec = _committed(name, "sweep.json")
    got = render_gallery(rec, tmp_path / "port")
    want = jax_render_gallery(rec, tmp_path / "jax")
    assert got
    _same_files(got, want)


def test_service_gallery_svg_bytes_equal_jax(tmp_path):
    rec = _committed("sustained_service", "service.json")
    got = render_service_gallery(rec, tmp_path / "port")
    want = jax_render_service_gallery(rec, tmp_path / "jax")
    assert len(got) == 3
    _same_files(got, want)


def test_group_mean_curves_equal_jax():
    rec = _committed("fig3_convergence", "sweep.json")
    got, want = group_mean_curves(rec), jax_group_mean_curves(rec)
    assert list(got) == list(want) and got
    for lab in want:
        assert got[lab][0] == want[lab][0]
        np.testing.assert_array_equal(got[lab][1], want[lab][1])


def _toy_record(rows):
    cells = []
    for i, (ds_name, n, k, ra, sa, ds, seed) in enumerate(rows):
        cells.append({
            "id": f"c{i}", "dataset": ds_name, "n_devices": n, "n_subchannels": k,
            "seed": seed, "policy": {"ds": ds, "ra": ra, "sa": sa,
                                     "label": f"{ds}+{ra}+{sa}"},
            "metrics": {"mean_subchannel_utilization": 0.5},
            "curves": {"round": [0, 1], "global_loss": [2.0 + i, 1.0],
                       "accuracy": [0.1, 0.2], "cum_time_s": [1.0, 2.0]},
            "trace": {"latency_s": [1.0, 1.0], "utilization": [0.5, 0.5]}})
    return {"cells": cells}


def test_group_mean_curves_refuses_pooling_like_jax():
    rec = _toy_record([("mnist", 8, 2, "mo", "matching", "alg3", 0),
                       ("mnist", 16, 2, "mo", "matching", "alg3", 0)])
    for fn in (group_mean_curves, jax_group_mean_curves):
        with pytest.raises(ValueError, match="n_devices"):
            fn(rec)
    got, want = group_mean_curves(rec, n_devices=8), jax_group_mean_curves(rec, n_devices=8)
    assert list(got) == list(want) == ["alg3+mo+matching"]
    np.testing.assert_array_equal(got["alg3+mo+matching"][1], want["alg3+mo+matching"][1])


def test_facets_split_heterogeneous_records(tmp_path):
    rec = _toy_record([("mnist", 8, 2, "mo", "matching", "alg3", 0),
                       ("mnist", 8, 2, "mo", "matching", "random", 0),
                       ("mnist", 16, 4, "mo", "matching", "alg3", 0),
                       ("mnist", 8, 2, "fix", "random", "alg3", 0)])
    assert {f.suffix for f in facets(rec)} == {
        "mnist-N8-K2-mo.matching", "mnist-N16-K4-mo.matching", "mnist-N8-K2-fix.random"}
    got = render_gallery(rec, tmp_path / "port")
    assert len(got) == 12
    _same_files(got, jax_render_gallery(rec, tmp_path / "jax"))


# --------------------------------------------------------------------------
# the artifact store
# --------------------------------------------------------------------------

def test_store_versioning(tmp_path):
    d1 = next_version_dir(tmp_path, "s")
    d2 = next_version_dir(tmp_path, "s")
    assert (d1.name, d2.name) == ("v0001", "v0002")
    write_record({"schema": 1, "cells": []}, d2)
    assert latest_dir(tmp_path, "s") == d2
    assert load_latest(tmp_path, "s") == {"schema": 1, "cells": []}
    assert load_latest(tmp_path, "never-ran") is None
    (d1 / "sweep.json").write_text(json.dumps({"schema": 99}))
    with pytest.raises(ValueError, match="schema"):
        load_record(d1)


def test_store_filename_roundtrip(tmp_path):
    d = next_version_dir(tmp_path, "svc")
    write_record({"kind": "sustained_service"}, d, filename="service.json")
    assert (d / "service.json").exists() and not (d / "sweep.json").exists()
    assert load_record(d, filename="service.json")["kind"] == "sustained_service"
    assert load_latest(tmp_path, "svc", filename="service.json")["schema"] == 1


def test_next_version_dir_stale_listing_retries(tmp_path, monkeypatch):
    """A writer that listed the versions just before another claimed one
    retries onto the next free slot instead of failing."""
    (tmp_path / "s" / "v0001").mkdir(parents=True)
    real = store._versions
    stale = {"pending": True}

    def racy_versions(sweep_dir):
        if stale.pop("pending", None):
            return []          # raced: another writer claimed v0001 already
        return real(sweep_dir)

    monkeypatch.setattr(store, "_versions", racy_versions)
    assert next_version_dir(tmp_path, "s").name == "v0002"


def test_next_version_dir_concurrent_claims_unique(tmp_path):
    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        names = list(pool.map(lambda _: next_version_dir(tmp_path, "s").name, range(24)))
    assert sorted(names) == [f"v{i:04d}" for i in range(1, 25)]
