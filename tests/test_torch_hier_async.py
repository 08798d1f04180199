"""The port's two-tier buffered async hierarchy (`fl.hier_async`) on the CPU.

  * against the JAX package's async hierarchy, with its draws injected
    (`inject_jax_hier_draws`): dispatches, commits at both tiers, AoU and
    pending counts exact; latencies (global and per cell), energy,
    convergence time and dispatch clocks within 1e-6 relative (both sides
    cast the same float64 Γ to float32); loss within 1e-4, accuracy within
    rtol 1e-4;
  * the degenerate limits, held by the port on its own: full buffers at
    BOTH tiers reproduce the port's sync hierarchy (`engine="scan"`) bit
    for bit, as do uniform clocks at any buffers; a hierarchy of ONE cell
    is the flat `engine="async"` run bit for bit;
  * the segmented runner chains two segments into the one run bit for bit;
  * routing: an async policy at either tier takes the event engine.
"""
from _torch_oracle import HIER_SMALL, SMALL, inject_jax_hier_draws, rel_err  # noqa: I001

import dataclasses

import numpy as np
import pytest
import torch

from repro.fl import AsyncAggregation as JaxAsyncAggregation
from repro.fl.hierarchical import HierSimConfig as JaxHierSimConfig
from repro.fl.hierarchical import run_hier_many as jax_run_hier_many
from repro_torch.core import RoundPolicy
from repro_torch.fl import (AsyncAggregation, HierSimConfig, SimConfig, run_hier_many,
                            run_hierarchical, run_many)
from repro_torch.fl import hierarchical as hier
from repro_torch.fl.hier_async import build_hier_async_runner, init_hier_async_carry
from repro_torch.fl.sim import _eval_mask, _group_trainer_and_policies

CPU = torch.device("cpu")
# The JAX package's pinned policy x scenario matrix
# (tests/test_hier_async_equivalence.py::POLICY_SCENARIOS).
POLICY_SCENARIOS = [
    ("alg3", "mo", "matching", "static"),
    ("alg3", "mo", "matching", "corr_fading"),
    ("alg3", "mo", "matching", "mobility"),
    ("alg3", "mo", "matching", "churn"),
    ("alg3", "mo", "matching", "urban"),
    ("aou_topk", "mo", "matching", "churn"),
    ("random", "fix", "random", "urban"),
    ("cluster", "mo", "random", "churn"),
    ("fixed", "fix", "matching", "urban"),
    ("random", "mo", "matching", "harvest"),
]
# (d): cell tier "async"; global tier "async" or a buffer of one.
JAX_CASES = {
    "async-async-static": ("async", "async", "static"),
    "async-async-churn": ("async", "async", "churn"),
    "async-buffer1-churn": ("async", dict(buffer=1, exponent=1.0), "churn"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: beside other
    test workers, torch's default (one thread per core each) oversubscribes
    the cores and slows every worker several-fold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(**kw) -> HierSimConfig:
    return HierSimConfig(**dict(HIER_SMALL, **kw))


def _agg(spec, cls):
    return cls(**spec) if isinstance(spec, dict) else spec


def _assert_bit_exact(sync, asy):
    """The sync-limit contract: everything the sync hierarchy records,
    bit for bit; every dispatch commits at its own event, at both tiers."""
    for name in ("tx_trace", "age_trace", "latency_all", "energy_all", "global_loss",
                 "accuracy", "n_selected", "n_transmitted", "cum_time_s", "deficits"):
        np.testing.assert_array_equal(getattr(sync, name), getattr(asy, name),
                                      err_msg=name)
    np.testing.assert_array_equal(asy.commit_trace, sync.tx_trace)
    assert not asy.async_trace["overflow"].any()
    assert asy.async_trace["n_pending"].max() == 0
    assert asy.async_trace["g_pending"].max() == 0


# --------------------------------------------------------------------------
# (d) against the JAX package
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_async():
    """Every (d) case through the JAX async hierarchy in one
    `run_hier_many` (one program; the JAX package pins vmap == solo)."""
    cfgs = [JaxHierSimConfig(**HIER_SMALL, aggregation=_agg(a, JaxAsyncAggregation),
                             global_aggregation=_agg(g, JaxAsyncAggregation),
                             scenario=s)
            for a, g, s in JAX_CASES.values()]
    return dict(zip(JAX_CASES, jax_run_hier_many(cfgs, engine="async",
                                                 ra_backend="bisect")))


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_async_matches_jax_async(monkeypatch, jax_async, case):
    inject_jax_hier_draws(monkeypatch)
    a, g, s = JAX_CASES[case]
    got = run_hier_many([_cfg(aggregation=_agg(a, AsyncAggregation),
                              global_aggregation=_agg(g, AsyncAggregation), scenario=s)],
                        device="cpu")[0]
    want = jax_async[case]
    for name in ("tx_trace", "age_trace", "commit_trace", "n_selected", "n_transmitted",
                 "rounds"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    for name in ("n_pending", "g_pending", "cell_committed", "overflow"):
        np.testing.assert_array_equal(got.async_trace[name], want.async_trace[name],
                                      err_msg=name)
    for name in ("latency_all", "energy_all", "cum_time_s"):
        assert rel_err(getattr(got, name), getattr(want, name)) < 1e-6, name
    for name in ("latency_cells", "rem_dispatch"):
        assert rel_err(got.async_trace[name], want.async_trace[name]) < 1e-6, name
    assert rel_err(got.global_loss, want.global_loss) < 1e-4
    np.testing.assert_allclose(got.accuracy, want.accuracy, rtol=1e-4, atol=0)
    # The case is really asynchronous at both tiers.
    assert got.async_trace["n_pending"].max() > 0
    assert got.async_trace["g_pending"].max() > 0
    assert not got.async_trace["overflow"].any()


# --------------------------------------------------------------------------
# (e) the degenerate limits
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ds,ra,sa,scenario", POLICY_SCENARIOS,
                         ids=[f"{d}-{r}-{s}-{sc}" for d, r, s, sc in POLICY_SCENARIOS])
def test_full_buffers_bit_exact_vs_scan(ds, ra, sa, scenario):
    cfg = _cfg(policy=RoundPolicy(ds, ra, sa), scenario=scenario)
    sync = run_hier_many([cfg], engine="scan", device="cpu")[0]
    asy = run_hier_many([cfg], engine="async", device="cpu")[0]
    _assert_bit_exact(sync, asy)


def test_full_buffers_any_staleness_bit_exact():
    """No commit is ever stale under full buffers, so no staleness preset
    can move the limit (f(0) == 1.0 exactly)."""
    sync = run_hier_many([_cfg(scenario="churn")], device="cpu")[0]
    for agg, g_agg in ((AsyncAggregation(buffer="full", staleness="poly"),
                        AsyncAggregation(buffer="full", staleness="poly")),
                       ("async_full", "async_full"),
                       (AsyncAggregation(buffer="full", staleness="const", exponent=0.0),
                        "sync")):
        asy = run_hier_many([_cfg(scenario="churn", aggregation=agg,
                                  global_aggregation=g_agg)], device="cpu")[0]
        _assert_bit_exact(sync, asy)


def test_uniform_clocks_any_buffers_degenerate_to_sync(monkeypatch):
    """Uniform per-device clocks make every upload of an event tie at the
    cell tier and every cell flight tie at the global tier, so buffers of
    one at both tiers still commit everything together."""
    orig = hier._solve_hier_horizons

    def flat_gamma(*args, **kw):
        ras_list, secs = orig(*args, **kw)
        return [[dataclasses.replace(ra, time_s=np.where(ra.feasible, 1.0, np.inf))
                 for ra in ras] for ras in ras_list], secs

    monkeypatch.setattr(hier, "_solve_hier_horizons", flat_gamma)
    sync = run_hier_many([_cfg()], engine="scan", device="cpu")[0]
    asy = run_hier_many([_cfg(aggregation=AsyncAggregation(buffer=1),
                              global_aggregation=AsyncAggregation(buffer=1))],
                        device="cpu")[0]
    _assert_bit_exact(sync, asy)


@pytest.mark.parametrize("aggregation,scenario", [
    ("async", "urban"), ("async_const", "churn"),
    (AsyncAggregation(buffer=1, staleness="poly", exponent=1.0), "churn"),
])
def test_single_cell_is_the_flat_async_engine(aggregation, scenario):
    """C == 1: the lone global slot commits in lockstep with the cell (an
    exact select), so every trace is the flat async engine's."""
    flat = run_many([SimConfig(**SMALL, aggregation=aggregation, scenario=scenario)],
                    engine="async", device="cpu")[0]
    one = run_hier_many([_cfg(n_cells=1, aggregation=aggregation, scenario=scenario)],
                        engine="async", device="cpu")[0]
    for name in ("global_loss", "accuracy", "latency_all", "energy_all", "tx_trace",
                 "age_trace", "commit_trace", "cum_time_s", "n_selected",
                 "n_transmitted"):
        np.testing.assert_array_equal(getattr(flat, name), getattr(one, name),
                                      err_msg=name)
    for name in ("n_pending", "rem_dispatch", "overflow"):
        np.testing.assert_array_equal(flat.async_trace[name], one.async_trace[name],
                                      err_msg=name)
    np.testing.assert_array_equal(one.async_trace["cell_committed"][:, 0],
                                  one.commit_trace.any(axis=1))
    assert flat.async_trace["n_pending"].max() > 0


def test_segmented_runner_chains_into_one_run():
    """Two segments of 3 events, the carry threaded between them, give the
    run of 6 events bit for bit (absolute event index through t0)."""
    cfg = _cfg(aggregation="async", global_aggregation="async", scenario="churn")
    prep = hier._prepare_hier(cfg, CPU)
    (ras,), _ = hier._solve_hier_horizons([prep], "fused", CPU)
    ras = hier._apply_hier_dynamics(prep, ras)
    model, trainer, policies, _ = _group_trainer_and_policies([cfg], CPU)
    spec, g_spec = hier._hier_async_specs(cfg)

    def data():
        d = hier._hier_scan_inputs(prep, ras, CPU)
        d.update(buffer=spec.resolve_buffer(8, 3), stale_exp=torch.tensor(0.5),
                 server_lr=torch.tensor(1.0), g_buffer=g_spec.resolve_buffer(2, 2),
                 g_stale_exp=torch.tensor(0.5), g_server_lr=torch.tensor(1.0))
        return d

    kw = dict(n_cells=2, k=3, n=8)
    mask = _eval_mask(cfg)
    whole = build_hier_async_runner(model, trainer, policies, rounds=6, eval_mask=mask,
                                    **kw)(data())
    d = data()
    carry = init_hier_async_carry(d["params0"], d["next_uniforms"], 2, 8)
    parts = []
    for t0 in (0, 3):
        seg = {**d, "t0": t0}
        for name in ("gamma", "feas", "energy", "sel_perms", "assign_perms"):
            seg[name] = d[name][t0:t0 + 3]
        run = build_hier_async_runner(model, trainer, policies, rounds=3,
                                      eval_mask=mask[t0:t0 + 3], segmented=True, **kw)
        carry, ys = run(seg, carry)
        parts.append(ys)
    for name, v in whole.items():
        torch.testing.assert_close(torch.cat([p[name] for p in parts]), v,
                                   rtol=0, atol=0, msg=name)
    assert whole["g_pending"].max() > 0 and whole["n_pending"].max() > 0


def test_async_policy_at_either_tier_routes_to_the_event_engine():
    cfgs = [_cfg(global_aggregation="async", scenario="churn"),
            _cfg(aggregation="async_const", scenario="churn"), _cfg(scenario="churn")]
    hists = run_hier_many(cfgs, engine="scan", device="cpu")
    assert hists[0].commit_trace is not None and hists[1].commit_trace is not None
    assert hists[2].commit_trace is None
    assert hists[0].async_trace["g_pending"].max() > 0
    out = run_hierarchical(cfgs[0], engine="loop", device="cpu")
    for name, shape in (("committed", (6, 2, 8)), ("cell_committed", (6, 2)),
                        ("latency_cells", (6, 2)), ("tx", (6, 2, 8))):
        assert out[name].shape == shape, name
    np.testing.assert_array_equal(out["committed"].reshape(6, -1), hists[0].commit_trace)
    np.testing.assert_array_equal(out["loss"], hists[0].global_loss)
