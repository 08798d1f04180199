"""The Γ solver's projection backends in the port against the JAX package.

  (a) `project_newton` and `project_newton_mixed` (cold, and warm from a
      parent's zeta) against the JAX functions of the same name on the
      same vertices; `project` dispatching every backend name;
  (b) `solve_pairs_step` and `solve_pairs_fused` for "bisect", "newton"
      and "mixed" against `solve_pairs_jit` with the same backend, on
      horizon draws with per-element budgets: `iterations` exact, the
      values within `TOL`;
  (c) the port's fused and step drivers bitwise equal per backend, and
      the plain backends routing round kernels K1 and K2;
  (d) `precompute_gamma` against the JAX package's and against stacked
      per-round solves;
  (e) every entry point with `ra_backend="mixed"` against the JAX
      package's same call with its draws injected: tx and AoU exact,
      latencies within 1e-6, losses within 1e-4;
  (f) an unknown backend refused with ValueError by every driver and
      entry point.

Tolerances (relative, on the feasible pairs), each the JAX package's
bound where the measured gap allows no tighter one.  The two packages take
log1p and exp from different libraries (XLA's own against torch's), which
differ in the last bit of ~5-15% of float64 arguments.  A converged Newton
root absorbs that; one that has not converged in its 14 steps does not:
where a candidate lands on a bracket end, the strict bracket test sends it
to the geometric mean, and the two packages leave their 14 steps at
different points.  So "newton" agrees with the JAX package's "newton" only
as closely as each agrees with the bisection.  Measured maxima on this
file's draws (one torch thread): "newton" projections 9.4e-10, the drivers
tau 8.5e-10, p 1.5e-10, time 7.3e-11, energy 3.2e-11; "mixed" projections
5.0e-15 cold and 3.0e-12 warm, the drivers tau 2.3e-12, p 4.0e-12, time
6.7e-13, energy 1.9e-13; "bisect" drivers tau 4.1e-12, p 8.3e-13, time
4.8e-13, energy 6.4e-16.
"""
from _torch_oracle import (HIER_SMALL, SMALL, enable_x64, feasible_pairs,  # noqa: I001
                           inject_jax_draws, inject_jax_hier_draws, rel_err)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RoundPolicy as JaxPolicy
from repro.core import WirelessConfig as JaxConfig
from repro.core import precompute_gamma as jax_precompute_gamma
from repro.core import solve_pairs_jit
from repro.experiments import SweepSpec as JaxSweepSpec
from repro.experiments import run_sweep as jax_run_sweep
from repro.fl import SimConfig as JaxSimConfig
from repro.fl import run_simulation as jax_run_simulation
from repro.fl.hierarchical import HierSimConfig as JaxHierSimConfig
from repro.fl.hierarchical import run_hierarchical as jax_run_hierarchical
from repro.kernels.polyblock_project import ops as jax_ops
from repro.service import ServiceConfig as JaxServiceConfig
from repro.service import SustainedService as JaxService
from repro_torch.core import RoundPolicy, WirelessConfig
from repro_torch.core import monotonic_torch
from repro_torch.core.monotonic_torch import (precompute_gamma, solve_pairs_fused,
                                              solve_pairs_step)
from repro_torch.experiments import SweepSpec, run_sweep
from repro_torch.fl import (HierSimConfig, SimConfig, run_hier_many, run_hierarchical,
                            run_many, run_simulation)
from repro_torch.kernels.polyblock_project import ops
from repro_torch.service import ServiceConfig, SustainedService

FIELDS = ("tau", "p", "time_s", "energy_j")
BACKENDS = ("bisect", "newton", "mixed")
# Per backend and field, the relative gap allowed against the JAX package's
# same backend (the measured maxima are in the module docstring).
TOL = {"bisect": dict(tau=1e-11, p=1e-11, time_s=1e-11, energy_j=1e-11),
       "newton": dict(tau=2e-9, p=5e-10, time_s=1e-10, energy_j=1e-10),
       "mixed": dict(tau=2e-11, p=2e-11, time_s=5e-12, energy_j=5e-12)}
# The projections' (zeta v) gaps, likewise: newton 9.4e-10 measured; mixed
# 5.0e-15 cold and 3.0e-12 warm from the parents' zeta.
PROJECT_TOL = {"newton": 2e-9, "mixed": 5e-14, "mixed-warm": 2e-11}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64))


def _vertex_sets(seed: int):
    """(label, v, beta, h2, e_max, hint) of the vertices the solver
    projects: (1, 1) of Prop-1 feasible pairs, the first iteration's two
    children of each (hint: the parent's zeta), and vertices uniform on
    [0.05, 1]^2.  Budgets per element."""
    beta, h2, _ = feasible_pairs(3000, seed)
    n = beta.shape[0]
    rng = np.random.default_rng(seed + 100)
    e_max = 0.02 * (0.5 + rng.uniform(size=n))
    with enable_x64():
        phi = np.asarray(jax_ops.project_jnp(jnp.ones((n, 2)), beta, h2, e_max,
                                             JaxConfig()))
    ones = np.ones(n)
    children = np.concatenate([np.stack([phi[:, 0], ones], -1),
                               np.stack([ones, phi[:, 1]], -1)])
    two = lambda x: np.concatenate([x, x])
    return [("ones", np.ones((n, 2)), beta, h2, e_max, None),
            ("children", children, two(beta), two(h2), two(e_max), two(phi[:, 0])),
            ("random", rng.uniform(0.05, 1.0, (n, 2)), beta, h2, e_max, None)]


# --------------------------------------------------------------------------
# (a) the projections
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,kw,tol", [
    ("project_newton", {}, "newton"),
    ("project_newton_mixed", {}, "mixed"),
    ("project_newton_mixed", dict(n_f32=4), "mixed"),
    ("project_newton_mixed", dict(n_f32=2, n_f64=1, hint=True), "mixed-warm"),
], ids=["newton", "mixed", "mixed-cold4", "mixed-warm"])
def test_projections_match_jax(seed, name, kw, tol):
    kw = dict(kw)
    warm = kw.pop("hint", False)
    for label, v, beta, h2, e_max, hint in _vertex_sets(seed):
        if warm and hint is None:
            continue
        with enable_x64():
            jkw = dict(kw, x0_hint=jnp.asarray(hint)) if warm else kw
            want = np.asarray(getattr(jax_ops, name)(jnp.asarray(v), beta, h2, e_max,
                                                      JaxConfig(), **jkw))
        tkw = dict(kw, x0_hint=_t(hint)) if warm else kw
        got = getattr(ops, name)(_t(v), _t(beta), _t(h2), _t(e_max), WirelessConfig(),
                                 **tkw)
        assert got.dtype == torch.float64 and got.shape == v.shape
        assert rel_err(got.numpy(), want) < PROJECT_TOL[tol], label
        # Every vertex outside G moved onto (or just inside) its boundary.
        assert np.all(got.numpy() <= v)


def test_mixed_bulk_runs_in_float32(monkeypatch):
    """The bulk of "mixed" is float32 arithmetic: every log1p but the
    float64 ones (g(v) and the polish) sees a float32 tensor."""
    dtypes = []
    log1p = torch.log1p
    monkeypatch.setattr(torch, "log1p", lambda x: (dtypes.append(x.dtype), log1p(x))[1])
    _, v, beta, h2, e_max, hint = _vertex_sets(0)[1]
    ops.project_newton_mixed(_t(v), _t(beta), _t(h2), _t(e_max), WirelessConfig(),
                             n_f32=2, n_f64=1, x0_hint=_t(hint))
    assert dtypes == [torch.float32] * 2 + [torch.float64] * 2


@pytest.mark.parametrize("backend,fn", [
    ("bisect", "project_bisect"), ("jnp", "project_bisect"),
    ("newton", "project_newton"), ("mixed", "project_newton_mixed"),
    ("cuda", "polyblock_project"), ("pallas", "polyblock_project"),
])
def test_project_dispatches_every_backend(backend, fn):
    _, v, beta, h2, e_max, _ = _vertex_sets(1)[2]
    args = (_t(v), _t(beta), _t(h2), _t(e_max), WirelessConfig())
    got = ops.project(*args, backend=backend)
    np.testing.assert_array_equal(got.numpy(), getattr(ops, fn)(*args).numpy())


def test_project_ref_backend_is_the_numpy_copy():
    _, v, beta, h2, e_max, _ = _vertex_sets(1)[2]
    got = ops.project(v, beta, h2, e_max, WirelessConfig(), backend="ref")
    with enable_x64():
        want = jax_ops.polyblock_project(v, beta, h2, e_max, JaxConfig(), backend="ref")
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# (b) the drivers against solve_pairs_jit, (c) fused == step
# --------------------------------------------------------------------------

def _horizon(seed, rounds, k=4, n=200, scale=3.0):
    """A (rounds, K, N) channel horizon with per-element budgets."""
    rng = np.random.default_rng(seed)
    h2 = rng.exponential(size=(rounds, k, n)) * scale
    beta = rng.integers(5, 60, n).astype(np.float64)
    e_max = 0.02 * (0.5 + rng.uniform(size=(rounds, 1, n)))
    return beta[None, None, :], h2, np.broadcast_to(e_max, h2.shape)


HORIZONS = [(3, 3, 40), (7, 6, 200), (11, 10, 100)]


def _assert_close(got, want, backend):
    np.testing.assert_array_equal(got.feasible, want.feasible)
    np.testing.assert_array_equal(got.iterations, want.iterations)
    f = want.feasible
    assert f.any() and (~f).any()
    for field in FIELDS:
        assert rel_err(getattr(got, field)[f], getattr(want, field)[f]) \
            < TOL[backend][field], field
    assert np.all(np.isinf(got.time_s[~f])) and np.all(np.isnan(got.tau[~f]))


def _assert_bitwise(a, b):
    for field in FIELDS + ("feasible", "iterations"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)


@pytest.mark.parametrize("horizon", HORIZONS, ids=[f"seed{h[0]}" for h in HORIZONS])
@pytest.mark.parametrize("backend", BACKENDS)
def test_drivers_match_jit_same_backend(horizon, backend):
    """Both drivers, each backend, against `solve_pairs_jit`: iterations
    exact, values within TOL; and the fused driver bitwise the step one."""
    seed, rounds, n = horizon
    beta, h2, e_max = _horizon(seed, rounds, n=n)
    want = solve_pairs_jit(beta, h2, JaxConfig(), e_max, backend=backend)
    step = solve_pairs_step(beta, h2, WirelessConfig(), e_max, backend=backend,
                            device="cpu")
    fused = solve_pairs_fused(beta, h2, WirelessConfig(), e_max, backend=backend,
                              device="cpu")
    _assert_close(step, want, backend)
    _assert_bitwise(fused, step)


@pytest.mark.parametrize("alias,name", [("jnp", "bisect"), ("pallas", "cuda"),
                                        (None, "cuda")])
def test_backend_aliases_are_bitwise_their_names(alias, name):
    beta, h2, e_max = _horizon(3, 2, n=30)
    for solve in (solve_pairs_step, solve_pairs_fused):
        a = solve(beta, h2, WirelessConfig(), e_max, backend=alias, device="cpu")
        b = solve(beta, h2, WirelessConfig(), e_max, backend=name, device="cpu")
        _assert_bitwise(a, b)


@pytest.mark.parametrize("backend", BACKENDS + ("cuda", None))
def test_backends_route_round_or_through_the_kernels(monkeypatch, backend):
    """The plain backends never reach K1's or K2's wrapper; None and
    "cuda" reach K1 on the fused driver and K2 on the step driver (their
    plain versions on the CPU) and nothing else."""
    calls = {"K1": 0, "K2": 0}

    def counted(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(monotonic_torch, "polyblock_solve_fused",
                        counted("K1", monotonic_torch.polyblock_solve_fused))
    monkeypatch.setattr(ops, "polyblock_project", counted("K2", ops.polyblock_project))
    beta, h2, e_max = _horizon(3, 2, n=30)
    solve_pairs_fused(beta, h2, WirelessConfig(), e_max, backend=backend, device="cpu")
    fused = dict(calls)
    res = solve_pairs_step(beta, h2, WirelessConfig(), e_max, backend=backend,
                           device="cpu")
    kernels = backend in ("cuda", None)
    assert fused == {"K1": int(kernels), "K2": 0}
    # The step driver projects (1, 1) once, then once per iteration.
    assert calls["K2"] == (1 + int(res.iterations.max()) if kernels else 0)
    assert calls["K1"] == fused["K1"]


def _service_pairs():
    """The feasible pairs of the first 100-event segment of the sustained
    service at `python -m repro_torch.service.run --ra mo`'s defaults (N 64,
    K 16, churn): what K1 solves per segment, 44 823 pairs."""
    from repro_torch.core import is_infeasible
    from repro_torch.fl.sim import _sample_dataset
    from repro_torch.scenarios import ScenarioStream
    sim = SimConfig(dataset="mnist", n_devices=64, n_subchannels=16, n_samples=128,
                    batch=16, local_steps=1, scenario="churn", aggregation="async",
                    policy=RoundPolicy(ra="mo"))
    beta = _sample_dataset(sim, np.random.default_rng(sim.seed), CPU)[2]
    tr = ScenarioStream(sim.seed, sim.wireless(), sim.scenario).next_segment(100)
    shape = tr.h2_all.shape
    beta = np.broadcast_to(beta[None, None, :], shape).reshape(-1)
    e_max = np.broadcast_to(tr.e_max_j[:, None, :], shape).reshape(-1)
    h2 = tr.h2_all.reshape(-1)
    keep = ~is_infeasible(h2, sim.wireless(), e_max)
    return beta[keep], h2[keep], e_max[keep]


def test_backend_gaps_at_the_service_pairs():
    """At the service's pairs, where some pairs run all 64 iterations, the
    JAX package's own "newton" sits 2.05e-8 (tau, p, T) from its bisection:
    some 14-step Newton roots there have not converged.  The port's
    "newton" keeps the JAX package's iterations, and lies within 5e-8 of
    its "newton" (2.05e-8 measured) and of its bisection (1.84e-8).  This
    gap sets the card's limit for "newton" (chip_smoke.py's RA_LIMITS)."""
    beta, h2, e_max = _service_pairs()
    assert beta.shape[0] == 44823
    bisect = solve_pairs_jit(beta, h2, JaxConfig(), e_max, backend="bisect")
    newton = solve_pairs_jit(beta, h2, JaxConfig(), e_max, backend="newton")
    got = solve_pairs_step(beta, h2, WirelessConfig(), e_max, backend="newton",
                           device="cpu")
    np.testing.assert_array_equal(newton.iterations, bisect.iterations)
    np.testing.assert_array_equal(got.iterations, newton.iterations)
    assert int(got.iterations.max()) == 64
    for field in ("tau", "p", "time_s"):
        jax_gap = rel_err(getattr(newton, field), getattr(bisect, field))
        assert 1e-8 < jax_gap < 5e-8, field
        assert rel_err(getattr(got, field), getattr(newton, field)) < 5e-8, field
        assert rel_err(getattr(got, field), getattr(bisect, field)) < 5e-8, field


# --------------------------------------------------------------------------
# (d) precompute_gamma
# --------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["fused", "step"])
@pytest.mark.parametrize("backend", ["mixed", None])
def test_precompute_gamma(solver, backend):
    """(rounds, K, N) fields; against the JAX package's (the same backend;
    the kernels' bisection against its "bisect") and bitwise the stacked
    per-round solves of the same driver."""
    beta, h2, e_max = _horizon(5, 4, n=60)
    beta_n = beta[0, 0]
    got = precompute_gamma(beta_n, h2, WirelessConfig(), e_max, solver=solver,
                           backend=backend, device="cpu")
    assert got.time_s.shape == h2.shape and got.iterations.shape == h2.shape
    jax_backend = "bisect" if backend is None else backend
    jax_solver = "fused" if solver == "fused" else "step"
    kw = {"shard": False} if jax_solver == "fused" else {}
    want = jax_precompute_gamma(beta_n, h2, JaxConfig(), e_max, solver=jax_solver,
                                backend=jax_backend, **kw)
    _assert_close(got, want, jax_backend)
    solve = solve_pairs_fused if solver == "fused" else solve_pairs_step
    rounds = [solve(beta_n[None, :], h2[r], WirelessConfig(), e_max[r],
                    backend=backend, device="cpu") for r in range(h2.shape[0])]
    for field in FIELDS + ("feasible", "iterations"):
        np.testing.assert_array_equal(
            getattr(got, field), np.stack([getattr(r, field) for r in rounds]),
            err_msg=field)


def test_precompute_gamma_refuses_an_unknown_solver():
    beta, h2, e_max = _horizon(5, 1, n=8)
    with pytest.raises(ValueError, match="solver"):
        precompute_gamma(beta[0, 0], h2, WirelessConfig(), e_max, solver="staged",
                         device="cpu")


# --------------------------------------------------------------------------
# (e) the entry points with ra_backend="mixed" against the JAX package
# --------------------------------------------------------------------------

def _assert_history(got, want):
    for name in ("tx_trace", "age_trace", "n_selected", "n_transmitted", "rounds"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert got.tx_trace.any()
    for name in ("latency_all", "energy_all", "cum_time_s"):
        assert rel_err(getattr(got, name), getattr(want, name)) < 1e-6, name
    assert rel_err(got.global_loss, want.global_loss) < 1e-4
    np.testing.assert_allclose(got.accuracy, want.accuracy, rtol=1e-4, atol=0)


@pytest.mark.parametrize("engine", ["loop", "scan"])
def test_run_simulation_mixed_matches_jax(monkeypatch, engine):
    inject_jax_draws(monkeypatch)
    got = run_simulation(SimConfig(**SMALL, scenario="churn"), engine=engine,
                         ra_backend="mixed", device="cpu")
    want = jax_run_simulation(JaxSimConfig(**SMALL, scenario="churn"), engine=engine,
                              ra_backend="mixed")
    _assert_history(got, want)


@pytest.mark.parametrize("engine", ["loop", "scan"])
def test_run_hierarchical_mixed_matches_jax(monkeypatch, engine):
    inject_jax_hier_draws(monkeypatch)
    got = run_hierarchical(HierSimConfig(**HIER_SMALL), engine=engine,
                           ra_backend="mixed", device="cpu")
    want = jax_run_hierarchical(JaxHierSimConfig(**HIER_SMALL), engine=engine,
                                ra_backend="mixed")
    for name in ("tx", "age", "eval_rounds"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert got["tx"].any()
    for name in ("latency", "energy", "cum_time_s"):
        assert rel_err(got[name], want[name]) < 1e-6, name
    assert rel_err(got["loss"], want["loss"]) < 1e-4


# Two cells: one flat (run_many), one of two cells (run_hier_many).
SWEEP2 = dict(name="t", datasets="mnist", ds=("alg3",), aggregation=("sync",),
              cell_counts=(1, 2), seeds=(0,), rounds=6, n_devices=8, n_subchannels=4,
              overrides={"n_samples": 96, "batch": 16, "local_steps": 2,
                         "eval_every": 2})


def test_run_sweep_mixed_matches_jax(monkeypatch):
    inject_jax_draws(monkeypatch)
    inject_jax_hier_draws(monkeypatch)
    got = run_sweep(SweepSpec(**SWEEP2), ra_backend="mixed", device="cpu", write=False)
    want = jax_run_sweep(JaxSweepSpec(**SWEEP2), ra_backend="mixed", write=False)
    assert len(got.histories) == len(want.histories) == 2
    assert {c["n_cells"] for c in got.record["cells"]} == {1, 2}
    for g, w in zip(got.histories, want.histories):
        _assert_history(g, w)


def test_service_mixed_matches_jax(monkeypatch):
    inject_jax_draws(monkeypatch)
    sim = dict(dataset="mnist", n_devices=8, n_subchannels=3, n_samples=96, batch=16,
               local_steps=1, scenario="churn", aggregation="async")
    got = SustainedService(ServiceConfig(sim=SimConfig(**sim, policy=RoundPolicy(ra="mo")),
                                         segment_events=8, eval_every_events=4),
                           ra_backend="mixed", device="cpu").run_segment()
    want = JaxService(JaxServiceConfig(sim=JaxSimConfig(**sim, policy=JaxPolicy(ra="mo")),
                                       segment_events=8, eval_every_events=4),
                      ra_backend="mixed").run_segment()
    for k in ("latency", "n_pending", "age", "committed", "transmitted", "selected"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert got["transmitted"].any()
    ev = np.nonzero(want["loss"])[0]
    assert rel_err(got["loss"][ev], want["loss"][ev]) < 1e-4


def test_group_entry_points_take_the_backend():
    """run_many and run_hier_many take the backend too: "mixed" and the
    default (K1's plain version) give the same traces here, where Γ agrees
    to ~1e-12 and decides nothing differently."""
    cfgs = [SimConfig(**SMALL, seed=s) for s in (0, 1)]
    for a, b in zip(run_many(cfgs, engine="scan", ra_backend="mixed", device="cpu"),
                    run_many(cfgs, engine="scan", device="cpu")):
        np.testing.assert_array_equal(a.tx_trace, b.tx_trace)
        assert rel_err(a.latency_all, b.latency_all) < 1e-6
    hcfg = [HierSimConfig(**HIER_SMALL)]
    a, b = (run_hier_many(hcfg, ra_backend=be, ra_solver="step", device="cpu")[0]
            for be in ("newton", None))
    np.testing.assert_array_equal(a.tx_trace, b.tx_trace)


# --------------------------------------------------------------------------
# (f) an unknown backend
# --------------------------------------------------------------------------

def _tiny_spec() -> SweepSpec:
    return SweepSpec(**dict(SWEEP2, cell_counts=(1,)))


UNKNOWN = {
    "solve_pairs_step": lambda b: solve_pairs_step(
        np.full(3, 20.0), np.ones((2, 3)), WirelessConfig(), backend=b, device="cpu"),
    "solve_pairs_fused": lambda b: solve_pairs_fused(
        np.full(3, 20.0), np.ones((2, 3)), WirelessConfig(), backend=b, device="cpu"),
    "precompute_gamma": lambda b: precompute_gamma(
        np.full(3, 20.0), np.ones((1, 2, 3)), WirelessConfig(), backend=b, device="cpu"),
    "project": lambda b: ops.project(
        torch.ones(2, 2, dtype=torch.float64), torch.full((2,), 20.0, dtype=torch.float64),
        torch.ones(2, dtype=torch.float64), torch.full((2,), 0.02, dtype=torch.float64),
        WirelessConfig(), backend=b),
    "run_simulation": lambda b: run_simulation(
        SimConfig(**SMALL, policy=RoundPolicy(ra="fix")), ra_backend=b, device="cpu"),
    "run_many": lambda b: run_many([SimConfig(**SMALL)], engine="scan", ra_backend=b,
                                   device="cpu"),
    "run_hierarchical": lambda b: run_hierarchical(
        HierSimConfig(**HIER_SMALL, policy=RoundPolicy(ra="fix")), ra_backend=b,
        device="cpu"),
    "run_hier_many": lambda b: run_hier_many([HierSimConfig(**HIER_SMALL)], ra_backend=b,
                                             device="cpu"),
    "run_sweep": lambda b: run_sweep(_tiny_spec(), ra_backend=b, device="cpu",
                                     write=False),
    "SustainedService": lambda b: SustainedService(
        ServiceConfig(sim=SimConfig(**SMALL, aggregation="async"), segment_events=4),
        ra_backend=b, device="cpu"),
}


@pytest.mark.parametrize("entry", list(UNKNOWN))
def test_unknown_backend_raises(monkeypatch, entry):
    """Refused before any work: a FIX-RA run, which never solves Γ, refuses
    it too, and no world is sampled."""
    def no_work(*args, **kw):
        raise AssertionError("work started before the backend was checked")

    from repro_torch.fl import hierarchical as hier
    from repro_torch.fl import sim
    monkeypatch.setattr(sim, "_prepare", no_work)
    monkeypatch.setattr(hier, "_prepare_hier", no_work)
    monkeypatch.setattr(monotonic_torch, "is_infeasible", no_work)
    with pytest.raises(ValueError, match="backend"):
        UNKNOWN[entry]("secant")


def test_solve_horizons_forward_the_backend():
    """`fl.sim._solve_horizons` hands the backend to the driver: one world
    solved by "newton" through either solver equals the driver's own
    solve of its horizon."""
    from repro_torch.fl import sim
    prep = sim._prepare(SimConfig(**SMALL), CPU)
    want = solve_pairs_step(prep.beta[None, None, :], prep.h2_all, prep.wcfg,
                            prep.emax_all[:, None, :], backend="newton", device="cpu")
    for solver in ("fused", "step"):
        (ra,), _ = sim._solve_horizons([prep], solver, CPU, "newton")
        for f in dataclasses.fields(ra):
            np.testing.assert_array_equal(getattr(ra, f.name), getattr(want, f.name),
                                          err_msg=f.name)
