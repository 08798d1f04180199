"""A `run_hier_many` group as one batch on a config axis (`fl.hierarchical`,
`fl.hier_async`), on the CPU.

  (a) mixed groups — five policies, three seeds, static / churn /
      corr_fading with `cell_coupling`, and on the async engine per-config
      commit operands at both tiers (buffer sizes, staleness exponents,
      server steps) — every config bitwise its solo `run_hier_many([cfg])`
      in every `SimHistory` field but the wall times, on both engines;
  (b) the port's ONE call over `tests/test_torch_hier.py`'s six scan cases
      and over `tests/test_torch_hier_async.py`'s three async cases against
      the JAX package's one call on the same configs, its draws injected
      (`inject_jax_hier_draws`): tx, AoU and counts exact; latency, energy
      and convergence time within 1e-6 relative; loss within 1e-4,
      accuracy within rtol 1e-4 (`tests/test_torch_hier.py`'s tolerances);
  (c) a group with `async_full` at both tiers bitwise the scan group;
  (d) host reads: each (round, cell) of a group reads
      1 + Σ over its policies of (the most any of that policy's configs
      reads alone at that round and cell, less its one who-trains read) —
      the flat group's bound (`tests/test_torch_batch.py`) carried to C
      cells, held with equality;
  (e) K3: aggregations counted on the plain path (`aggregate` /
      `aggregate_buffered` wrapped to count): scan, one per (round, cell
      index) in which any config's cell trained plus one global per round;
      async, rounds x (C + 1) whatever the group's size; each call takes
      every config of the group;
  (f) `wall_s` by the JAX package's rule, for flat and hierarchy groups:
      the group's wall time divided by its size plus the member's own
      `plan_wall_s`, so `wall_s - plan_wall_s` is one value for every
      member and the members' `wall_s` sum to at most the call's time.
"""
from _torch_oracle import HIER_SMALL, SMALL, inject_jax_hier_draws, rel_err  # noqa: I001

import dataclasses
import time

import numpy as np
import pytest
import torch

from repro.core import RoundPolicy as JaxPolicy
from repro.fl import AsyncAggregation as JaxAsyncAggregation
from repro.fl.hierarchical import HierSimConfig as JaxHierSimConfig
from repro.fl.hierarchical import run_hier_many as jax_run_hier_many
from repro_torch.core import RoundPolicy
from repro_torch.core.leader_torch import host_int
from repro_torch.fl import (AsyncAggregation, HierSimConfig, SimConfig, run_hier_many,
                            run_many)
from repro_torch.fl import async_loop, engine_common, hier_async
from repro_torch.fl import hierarchical as hier

# (a): one group per engine, C = 3 cells of 8 devices and 3 sub-channels.
MIXED = [("alg3", "mo", "matching", 0, "churn", 0.0),
         ("aou_topk", "mo", "matching", 1, "static", 0.0),
         ("random", "fix", "random", 0, "corr_fading", 0.5),
         ("cluster", "mo", "random", 2, "churn", 0.0),
         ("fixed", "fix", "matching", 1, "corr_fading", 0.5),
         ("alg3", "mo", "matching", 2, "static", 0.0)]
# The async group's commit operands per config: (cell tier, global tier).
MIXED_AGG = [(AsyncAggregation(), AsyncAggregation()),
             (AsyncAggregation(buffer=1, exponent=1.0), AsyncAggregation(buffer=2)),
             (AsyncAggregation(buffer=2, server_lr=0.5), "sync"),
             ("async_const", AsyncAggregation(buffer=1, exponent=1.0, server_lr=0.5)),
             ("sync", AsyncAggregation(buffer="full", staleness="poly")),
             (AsyncAggregation(staleness="const"), "async")]
# (b): tests/test_torch_hier.py's CASES and tests/test_torch_hier_async.py's JAX_CASES.
CASES = [(pol, scenario)
         for pol in (("alg3", "mo", "matching"), ("random", "fix", "matching"),
                     ("cluster", "mo", "random"))
         for scenario in ("static", "churn")]
ASYNC_CASES = [("async", "async", "static"), ("async", "async", "churn"),
               ("async", dict(buffer=1, exponent=1.0), "churn")]
FIELDS = ("tx_trace", "age_trace", "n_selected", "n_transmitted", "rounds")


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


def _mixed(engine: str) -> list[HierSimConfig]:
    out = []
    for (ds, ra, sa, seed, scenario, coupling), (agg, g_agg) in zip(MIXED, MIXED_AGG):
        kw = {} if engine == "scan" else dict(aggregation=agg, global_aggregation=g_agg)
        out.append(_cfg(n_cells=3, policy=RoundPolicy(ds, ra, sa), seed=seed,
                        scenario=scenario, cell_coupling=coupling, **kw))
    return out


def _diff(a, b) -> list[str]:
    """The fields of two histories, but the wall times, that differ in any
    bit."""
    out = []
    for f in dataclasses.fields(a):
        if f.name in ("wall_s", "plan_wall_s"):
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, dict):
            same = x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        else:
            same = np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y
        if not same:
            out.append(f.name)
    return out


class _Counted:
    """Wraps `owner.name` while open; `calls` records one entry per call,
    `record(args, kwargs, out, reads)`'s value."""

    def __init__(self, monkeypatch, owner, name, record):
        self.calls = []
        body = getattr(owner, name)

        def counted(*args, **kw):
            before = host_int.syncs
            out = body(*args, **kw)
            self.calls.append(record(args, kw, out, host_int.syncs - before))
            return out

        monkeypatch.setattr(owner, name, counted)


# --------------------------------------------------------------------------
# (a) mixed groups, each config bitwise its solo run
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed_groups():
    cache = {}

    def get(engine):
        if engine not in cache:
            cfgs = _mixed(engine)
            cache[engine] = cfgs, run_hier_many(cfgs, engine="scan", device="cpu")
        return cache[engine]

    return get


@pytest.mark.parametrize("i", range(len(MIXED)))
@pytest.mark.parametrize("engine", ["scan", "async"])
def test_mixed_group_member_is_its_solo_run(mixed_groups, engine, i):
    cfgs, hists = mixed_groups(engine)
    got = hists[i]
    assert (got.commit_trace is None) == (engine == "scan")
    assert got.tx_trace.shape == (6, 24) and got.tx_trace.any()
    solo = run_hier_many([cfgs[i]], device="cpu")[0]
    assert _diff(got, solo) == []


def test_mixed_async_group_is_really_asynchronous(mixed_groups):
    _, hists = mixed_groups("async")
    assert max(h.async_trace["n_pending"].max() for h in hists) > 0
    assert max(h.async_trace["g_pending"].max() for h in hists) > 0
    assert not any(h.async_trace["overflow"].any() for h in hists)


# --------------------------------------------------------------------------
# (b) one port call against one JAX call
# --------------------------------------------------------------------------

def _agg(spec, cls):
    return cls(**spec) if isinstance(spec, dict) else spec


@pytest.fixture(scope="module")
def scan_calls():
    """The six cases through one call of each package (the JAX one in one
    vmapped program, the port's on one config axis)."""
    jcfgs = [JaxHierSimConfig(**HIER_SMALL, policy=JaxPolicy(*p), scenario=s)
             for p, s in CASES]
    want = jax_run_hier_many(jcfgs, engine="scan", ra_backend="bisect")
    with pytest.MonkeyPatch.context() as mp:
        inject_jax_hier_draws(mp)
        got = run_hier_many([_cfg(policy=RoundPolicy(*p), scenario=s) for p, s in CASES],
                            engine="scan", device="cpu")
    return got, want


@pytest.fixture(scope="module")
def async_calls():
    jcfgs = [JaxHierSimConfig(**HIER_SMALL, aggregation=_agg(a, JaxAsyncAggregation),
                              global_aggregation=_agg(g, JaxAsyncAggregation), scenario=s)
             for a, g, s in ASYNC_CASES]
    want = jax_run_hier_many(jcfgs, engine="async", ra_backend="bisect")
    with pytest.MonkeyPatch.context() as mp:
        inject_jax_hier_draws(mp)
        got = run_hier_many([_cfg(aggregation=_agg(a, AsyncAggregation),
                                  global_aggregation=_agg(g, AsyncAggregation), scenario=s)
                             for a, g, s in ASYNC_CASES], device="cpu")
    return got, want


def _assert_matches_jax(got, want):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for name in ("latency_all", "energy_all", "cum_time_s"):
        assert rel_err(getattr(got, name), getattr(want, name)) < 1e-6, name
    assert rel_err(got.global_loss, want.global_loss) < 1e-4
    np.testing.assert_allclose(got.accuracy, want.accuracy, rtol=1e-4, atol=0)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=["-".join(p) + "-" + s for p, s in CASES])
def test_scan_group_matches_the_jax_group(scan_calls, i):
    got, want = scan_calls
    assert got[i].tx_trace.any()
    _assert_matches_jax(got[i], want[i])


@pytest.mark.parametrize("i", range(len(ASYNC_CASES)),
                         ids=["async-async-static", "async-async-churn",
                              "async-buffer1-churn"])
def test_async_group_matches_the_jax_group(async_calls, i):
    got, want = async_calls
    _assert_matches_jax(got[i], want[i])
    np.testing.assert_array_equal(got[i].commit_trace, want[i].commit_trace)
    for name in ("n_pending", "g_pending", "cell_committed", "overflow"):
        np.testing.assert_array_equal(got[i].async_trace[name], want[i].async_trace[name],
                                      err_msg=name)
    for name in ("latency_cells", "rem_dispatch"):
        assert rel_err(got[i].async_trace[name], want[i].async_trace[name]) < 1e-6, name
    assert got[i].async_trace["g_pending"].max() > 0


# --------------------------------------------------------------------------
# (c) async_full at both tiers: the scan group bit for bit
# --------------------------------------------------------------------------

def test_async_full_group_is_the_scan_group():
    cfgs = _mixed("scan")[:4]
    sync = run_hier_many(cfgs, engine="scan", device="cpu")
    asy = run_hier_many([dataclasses.replace(c, aggregation="async_full",
                                             global_aggregation="async_full")
                         for c in cfgs], device="cpu")
    for s, a in zip(sync, asy):
        for name in ("tx_trace", "age_trace", "latency_all", "energy_all", "global_loss",
                     "accuracy", "n_selected", "n_transmitted", "cum_time_s", "deficits"):
            np.testing.assert_array_equal(getattr(s, name), getattr(a, name), err_msg=name)
        np.testing.assert_array_equal(a.commit_trace, s.tx_trace)
        assert a.async_trace["n_pending"].max() == 0 and a.async_trace["g_pending"].max() == 0


# --------------------------------------------------------------------------
# (d) host reads per (round, cell) and per round
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["scan", "async"])
def test_host_reads_per_round_within_the_bound(monkeypatch, engine):
    cfgs = _mixed(engine)
    owner, name = ((hier, "sync_group_round") if engine == "scan"
                   else (hier_async, "group_event"))
    reads = _Counted(monkeypatch, owner, name, lambda a, kw, out, n: n)
    run_hier_many(cfgs, device="cpu")
    group = list(reads.calls)
    solo = []
    for c in cfgs:
        reads.calls.clear()
        run_hier_many([c], device="cpu")
        solo.append(list(reads.calls))
    n_calls = cfgs[0].rounds * cfgs[0].n_cells
    assert len(group) == n_calls and all(len(s) == n_calls for s in solo)
    policies = {(c.policy.ds, c.policy.sa) for c in cfgs}
    want = [1 + sum(max(solo[i][j] - 1 for i, c in enumerate(cfgs)
                        if (c.policy.ds, c.policy.sa) == p) for p in policies)
            for j in range(n_calls)]
    assert group == want
    per_round = np.add.reduceat(group, np.arange(0, n_calls, cfgs[0].n_cells))
    serial = np.add.reduceat(np.sum(solo, axis=0), np.arange(0, n_calls, cfgs[0].n_cells))
    assert (per_round < serial).all()


# --------------------------------------------------------------------------
# (e) K3 calls against the rule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["scan", "async"])
def test_k3_calls_follow_the_group_rule(monkeypatch, engine):
    cfgs = _mixed(engine)
    g, rounds, n_cells = len(cfgs), cfgs[0].rounds, cfgs[0].n_cells
    calls = []
    shape = lambda a, kw, out, n: tuple(a[2].shape)  # noqa: E731 (the weights)
    if engine == "scan":
        for owner in (engine_common, hier):
            calls.append(_Counted(monkeypatch, owner, "aggregate", shape).calls)
    else:
        for owner in (async_loop, hier_async):
            calls.append(_Counted(monkeypatch, owner, "aggregate_buffered", shape).calls)
    hists = run_hier_many(cfgs, device="cpu")
    cell_calls, global_calls = calls
    if engine == "scan":
        tx = np.stack([h.tx_trace.reshape(rounds, n_cells, -1) for h in hists])
        trained = tx.any(axis=(0, 3))                      # (rounds, C)
        assert trained.any()
        assert len(cell_calls) == int(trained.sum())
        assert cell_calls == [(g, cfgs[0].subchannels_per_cell)] * len(cell_calls)
    else:
        assert cell_calls == [(g, cfgs[0].subchannels_per_cell)] * rounds * n_cells
    assert global_calls == [(g, n_cells)] * rounds


# --------------------------------------------------------------------------
# (f) wall_s by the JAX package's rule
# --------------------------------------------------------------------------

def _assert_wall_rule(hists, elapsed):
    shares = [h.wall_s - h.plan_wall_s for h in hists]
    assert min(shares) > 0
    assert shares == pytest.approx([shares[0]] * len(shares), rel=1e-9, abs=1e-12)
    assert sum(h.wall_s for h in hists) <= elapsed


@pytest.mark.parametrize("engine", ["scan", "async"])
def test_wall_s_splits_the_group_time(engine):
    flat = [SimConfig(**SMALL, seed=s, policy=RoundPolicy(ds=d))
            for d, s in (("alg3", 0), ("random", 1), ("alg3", 2))]
    t0 = time.perf_counter()
    hists = run_many(flat, engine=engine, device="cpu")
    _assert_wall_rule(hists, time.perf_counter() - t0)
    cfgs = _mixed(engine)[:3]
    t0 = time.perf_counter()
    hists = run_hier_many(cfgs, device="cpu")
    _assert_wall_rule(hists, time.perf_counter() - t0)
    assert any(h.plan_wall_s > 0 for h in hists)
