"""The port's multi-cell hierarchy (`fl.hierarchical`): world, Γ, and the
loop and scan engines, on the CPU against the JAX package.

  * the world: `sample_coupled_fading` and `_prepare_hier` bit-identical
    to the JAX package's for the same seed;
  * Γ: each cell's slice of the one concatenated solve bitwise equal to a
    solo solve of that cell, and held to the JAX package's solve as
    tests/test_torch_solvers.py holds the flat one (iterations and
    feasibility exact, values within 1e-12 relative);
  * the engines against the JAX package's, with its draws injected
    (`inject_jax_hier_draws`): tx, AoU and counts exact; latency, energy
    and convergence time within 1e-9 relative on the loop engine (float64
    on both sides) and 1e-6 on scan (both cast the same float64 Γ to
    float32); loss within 1e-4, accuracy within rtol 1e-4 (float32
    training whose sums the frameworks order differently);
  * the port on its own: scan == loop to the flat engines' tolerances
    (tests/test_torch_engines.py), a single-cell hierarchy == the flat
    scan engine bit for bit, one learning-plane block per (round, cell)
    that trains, and the entry points' refusals.
"""
from _torch_oracle import HIER_SMALL, SMALL, inject_jax_hier_draws, rel_err  # noqa: I001

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro.core import RoundPolicy as JaxPolicy
from repro.core import WirelessConfig as JaxWireless
from repro.fl.hierarchical import HierSimConfig as JaxHierSimConfig
from repro.fl.hierarchical import _prepare_hier as jax_prepare_hier
from repro.fl.hierarchical import _solve_hier_horizons as jax_solve_hier_horizons
from repro.fl.hierarchical import run_hier_many as jax_run_hier_many
from repro.fl.hierarchical import run_hierarchical as jax_run_hierarchical
from repro.scenarios import FadingProcess as JaxFading
from repro.scenarios import sample_coupled_fading as jax_sample_coupled_fading
from repro_torch.core import RoundPolicy, WirelessConfig
from repro_torch.core.monotonic_torch import solve_pairs_fused, solve_pairs_step
from repro_torch.fl import HierSimConfig, SimConfig, run_hier_many, run_hierarchical
from repro_torch.fl import hierarchical as hier
from repro_torch.fl import run_simulation
from repro_torch.fl.sim import _prepare
from repro_torch.scenarios import FadingProcess, sample_coupled_fading, sample_fading

CPU = torch.device("cpu")
COMBOS = list(itertools.product(("alg3", "aou_topk", "random", "cluster", "fixed"),
                                ("mo", "fix"), ("matching", "random")))
# (d): the proposed policy and two baselines, each in a static and a churning world.
CASES = [(pol, scenario)
         for pol in (("alg3", "mo", "matching"), ("random", "fix", "matching"),
                     ("cluster", "mo", "random"))
         for scenario in ("static", "churn")]
CASE_IDS = ["-".join(p) + "-" + s for p, s in CASES]
_WORLD = ("beta", "clusters", "fixed_ids", "h2_all", "sel_perms", "assign_perms",
          "distances", "avail", "slowdown", "emax_all")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: beside other
    test workers, torch's default (one thread per core each) oversubscribes
    the cores and slows every worker several-fold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(**kw):
    """The port's and the JAX package's config for the same settings."""
    pol = kw.pop("policy", None)
    kw = dict(HIER_SMALL, **kw)
    if pol is None:
        return HierSimConfig(**kw), JaxHierSimConfig(**kw)
    return (HierSimConfig(**kw, policy=RoundPolicy(*pol)),
            JaxHierSimConfig(**kw, policy=JaxPolicy(*pol)))


# --------------------------------------------------------------------------
# (a) coupled fading, (b) the prepared world
# --------------------------------------------------------------------------

@pytest.mark.parametrize("coupling", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("kind", ["iid", "ar1"])
def test_coupled_fading_bit_identical(kind, coupling):
    rho = 0.9 if kind == "ar1" else 0.0
    got_rng, want_rng = np.random.default_rng(7), np.random.default_rng(7)
    got = sample_coupled_fading(got_rng, WirelessConfig(n_devices=5, n_subchannels=3),
                                FadingProcess(kind, rho), 4, 3, coupling)
    want = jax_sample_coupled_fading(want_rng, JaxWireless(n_devices=5, n_subchannels=3),
                                     JaxFading(kind, rho), 4, 3, coupling)
    assert got.shape == (3, 4, 3, 5)
    np.testing.assert_array_equal(got, want)
    assert got_rng.bit_generator.state == want_rng.bit_generator.state
    if coupling == 0.0:
        # The uncoupled stream: per-cell `sample_fading` calls in cell order.
        rng = np.random.default_rng(7)
        cells = [sample_fading(rng, WirelessConfig(n_devices=5, n_subchannels=3),
                               FadingProcess(kind, rho), 4) for _ in range(3)]
        np.testing.assert_array_equal(got, np.stack(cells))
    if coupling == 1.0:
        np.testing.assert_array_equal(got[0], got[2])     # one shared field


@pytest.mark.parametrize("coupling", [-0.1, 1.5])
def test_coupled_fading_rejects_coupling_outside_unit_interval(coupling):
    with pytest.raises(ValueError, match="coupling"):
        sample_coupled_fading(np.random.default_rng(0), WirelessConfig(),
                              FadingProcess(), 2, 2, coupling)


@pytest.mark.parametrize("scenario,coupling", [("static", 0.0), ("urban", 0.0),
                                               ("corr_fading", 0.5)])
def test_prepare_hier_bit_identical(scenario, coupling):
    cfg, jcfg = _pair(scenario=scenario, cell_coupling=coupling)
    got, want = hier._prepare_hier(cfg, CPU), jax_prepare_hier(jcfg)
    for name in _WORLD:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for name in ("x", "y", "m"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(got.ds.x, want.ds.x)
    np.testing.assert_array_equal(got.ds.y, want.ds.y)
    assert got.rng.bit_generator.state == want.rng.bit_generator.state
    assert got.h2_all.shape == (2, 6, 3, 8)


def test_single_cell_world_is_the_flat_world():
    """At C == 1 every block of the hierarchy's stream is one flat-stream
    call in the flat order: the world of the flat `_prepare`."""
    got = hier._prepare_hier(HierSimConfig(**dict(HIER_SMALL, n_cells=1),
                                           scenario="urban"), CPU)
    want = _prepare(SimConfig(**SMALL, scenario="urban"), CPU)
    for name in _WORLD:
        np.testing.assert_array_equal(getattr(got, name)[0], getattr(want, name),
                                      err_msg=name)
    np.testing.assert_array_equal(got.x[0].numpy(), want.x_all.numpy())
    assert got.rng.bit_generator.state == want.rng.bit_generator.state


# --------------------------------------------------------------------------
# (c) Γ: one solve over every cell's pairs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["fused", "step"])
def test_gamma_cells_concatenate_bitwise(solver):
    cfg, jcfg = _pair(scenario="urban")
    prep = hier._prepare_hier(cfg, CPU)
    (ras,), _ = hier._solve_hier_horizons([prep], solver, CPU)
    (want,), _ = jax_solve_hier_horizons([jax_prepare_hier(jcfg)], "bisect")
    solve = solve_pairs_fused if solver == "fused" else solve_pairs_step
    for c, ra in enumerate(ras):
        solo = solve(prep.beta[c][None, None, :], prep.h2_all[c], prep.wcfg,
                     prep.emax_all[c][:, None, :], device="cpu")
        for f in dataclasses.fields(ra):
            np.testing.assert_array_equal(getattr(ra, f.name), getattr(solo, f.name),
                                          err_msg=f"cell {c} {f.name}")
        w = want[c]
        np.testing.assert_array_equal(ra.feasible, w.feasible)
        np.testing.assert_array_equal(ra.iterations, w.iterations)
        f = w.feasible
        assert f.any() and (~f).any()
        for name in ("tau", "p", "time_s", "energy_j"):
            assert rel_err(getattr(ra, name)[f], getattr(w, name)[f]) < 1e-12, name


def test_gamma_shared_world_is_solved_once():
    """Policy-only variants alias one prepared world and one solve per RA
    scheme."""
    cfgs = [HierSimConfig(**HIER_SMALL, policy=RoundPolicy(ds=ds, ra=ra))
            for ds, ra in (("alg3", "mo"), ("random", "mo"), ("alg3", "fix"))]
    prep = hier._prepare_hier(cfgs[0], CPU)
    preps = [dataclasses.replace(prep, cfg=c) for c in cfgs]
    out, _ = hier._solve_hier_horizons(preps, "fused", CPU)
    assert out[0] is out[1] and out[2] is not out[0]
    assert not np.array_equal(out[0][0].time_s, out[2][0].time_s)


# --------------------------------------------------------------------------
# (d) the engines against the JAX package
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_loop():
    """JAX loop-engine runs, computed once per case."""
    cache = {}

    def get(pol, scenario):
        if (pol, scenario) not in cache:
            _, jcfg = _pair(policy=pol, scenario=scenario)
            cache[pol, scenario] = jax_run_hierarchical(jcfg, engine="loop",
                                                        ra_backend="bisect")
        return cache[pol, scenario]

    return get


@pytest.fixture(scope="module")
def jax_scan():
    """Every (d) case through the JAX scan engine in one `run_hier_many`
    (one program for the group; the JAX package pins vmap == solo)."""
    hists = jax_run_hier_many([_pair(policy=p, scenario=s)[1] for p, s in CASES],
                              engine="scan", ra_backend="bisect")
    return dict(zip(CASES, hists))


def _assert_curves(got: dict, want: dict, tol: float):
    """Eval-round curves of two runs: exact rounds, float64-latency
    traces to `tol`, float32 losses to 1e-4."""
    np.testing.assert_array_equal(got["eval_rounds"], want["eval_rounds"])
    for name in ("latency", "energy", "cum_time_s"):
        assert rel_err(got[name], want[name]) < tol, name
    assert rel_err(got["loss"], want["loss"]) < 1e-4
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], rtol=1e-4, atol=0)


@pytest.mark.parametrize("pol,scenario", CASES, ids=CASE_IDS)
def test_loop_matches_jax_loop(monkeypatch, jax_loop, pol, scenario):
    inject_jax_hier_draws(monkeypatch)
    cfg, _ = _pair(policy=pol, scenario=scenario)
    got = run_hierarchical(cfg, engine="loop", device="cpu")
    want = jax_loop(pol, scenario)
    np.testing.assert_array_equal(got["tx"], want["tx"])
    np.testing.assert_array_equal(got["age"], want["age"])
    assert got["tx"].any() and got["tx"].shape == (6, 2, 8)
    _assert_curves(got, want, 1e-9)


@pytest.mark.parametrize("pol,scenario", CASES, ids=CASE_IDS)
def test_scan_matches_jax_scan(monkeypatch, jax_scan, pol, scenario):
    inject_jax_hier_draws(monkeypatch)
    got = run_hier_many([_pair(policy=pol, scenario=scenario)[0]], engine="scan",
                        device="cpu")[0]
    want = jax_scan[pol, scenario]
    for name in ("tx_trace", "age_trace", "n_selected", "n_transmitted", "rounds"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert got.tx_trace.any() and got.tx_trace.shape == (6, 16)
    for name in ("latency_all", "energy_all", "cum_time_s"):
        assert rel_err(getattr(got, name), getattr(want, name)) < 1e-6, name
    assert rel_err(got.global_loss, want.global_loss) < 1e-4
    np.testing.assert_allclose(got.accuracy, want.accuracy, rtol=1e-4, atol=0)


# --------------------------------------------------------------------------
# (e) the port on its own
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ds,ra,sa", COMBOS, ids=[f"{d}-{r}-{s}" for d, r, s in COMBOS])
def test_scan_matches_loop_all_policies(ds, ra, sa):
    """The flat engines' contract: the device leader plane runs in float32
    and the loop in float64, so latency and energy agree to 1e-5 relative;
    the loop stacks only the cells that transmitted and scan all C, so the
    losses agree to 1e-3, not bit for bit."""
    cfg = HierSimConfig(**HIER_SMALL, scenario="churn", policy=RoundPolicy(ds, ra, sa))
    a = run_hierarchical(cfg, engine="loop", device="cpu")
    b = run_hierarchical(cfg, engine="scan", device="cpu")
    np.testing.assert_array_equal(a["tx"], b["tx"])
    np.testing.assert_array_equal(a["age"], b["age"])
    np.testing.assert_array_equal(a["eval_rounds"], b["eval_rounds"])
    np.testing.assert_allclose(b["latency"], a["latency"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(b["energy"], a["energy"], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(b["cum_time_s"], a["cum_time_s"], rtol=1e-5)
    np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-3)


def test_single_cell_scan_is_the_flat_scan():
    """C == 1: the world, Γ, the draws and every float op of the flat scan
    engine (the global eq. 34 over one slot is an exact select)."""
    flat = run_simulation(SimConfig(**SMALL, scenario="urban"), engine="scan", device="cpu")
    one = run_hier_many([HierSimConfig(**dict(HIER_SMALL, n_cells=1), scenario="urban")],
                        device="cpu")[0]
    for name in ("global_loss", "accuracy", "latency_all", "energy_all", "tx_trace",
                 "age_trace", "cum_time_s", "n_selected", "n_transmitted", "deficits"):
        np.testing.assert_array_equal(getattr(one, name), getattr(flat, name),
                                      err_msg=name)


@pytest.mark.parametrize("engine", ["loop", "scan"])
def test_one_block_per_training_cell(monkeypatch, engine):
    """The learning plane draws one (subchannels_per_cell, local_steps,
    batch) block per (round, cell) in which the cell trains, and nothing
    for a silent cell (HierSimConfig.n_subchannels is C*K)."""
    blocks = []
    draws = hier.training_draws

    def counted(cfg, batch, device, k=None):
        params, next_u = draws(cfg, batch, device, k)

        def next_block():
            blocks.append(next_u())
            return blocks[-1]
        return params, next_block

    monkeypatch.setattr(hier, "training_draws", counted)
    cfg = HierSimConfig(**HIER_SMALL, scenario="churn", policy=RoundPolicy(ds="random"))
    out = run_hierarchical(cfg, engine=engine, device="cpu")
    trains = out["tx"].any(axis=2)
    assert trains.any() and not trains.all()
    assert len(blocks) == int(trains.sum())
    assert all(b.shape == (3, 2, 16) for b in blocks)


# --------------------------------------------------------------------------
# (f) refusals
# --------------------------------------------------------------------------

def test_entry_points_refuse_unknown_names():
    cfg = HierSimConfig(**dict(HIER_SMALL, rounds=1))
    with pytest.raises(ValueError, match="unknown engine"):
        run_hierarchical(cfg, engine="warp", device="cpu")
    with pytest.raises(ValueError, match="run_hierarchical-only"):
        run_hier_many([cfg], engine="loop", device="cpu")
    with pytest.raises(ValueError, match="unknown ra_solver"):
        run_hier_many([cfg], ra_solver="newton", device="cpu")
    with pytest.raises(ValueError, match="unknown aggregation"):
        run_hierarchical(dataclasses.replace(cfg, global_aggregation="eventual"),
                         device="cpu")


def test_entry_points_refuse_a_silent_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: device=None is valid here")
    cfg = HierSimConfig(**dict(HIER_SMALL, rounds=1))
    for call in (lambda: run_hierarchical(cfg), lambda: run_hier_many([cfg])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_f32_priority_guard():
    cfg = HierSimConfig(**HIER_SMALL)
    prep = hier._prepare_hier(cfg, CPU)
    big = dataclasses.replace(prep, beta=np.full_like(prep.beta, 2.0 ** 24))
    with pytest.raises(ValueError, match="2\\^24"):
        hier._check_hier_f32([big])
    hier._check_hier_f32([prep])
