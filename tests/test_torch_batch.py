"""A `run_many` group of cells as one batch on a leading cell axis, on the CPU.

The scan and async engines run a group's cells as ONE loop
(`repro_torch.fl.engine_common`, the port of the JAX package's `vmap` over
a group).  The contract: every cell is bitwise its solo run, in every
`SimHistory` field but the wall times.  Pinned here piece by piece:

  * K3's cell-axis entry (`fedavg_aggregate_leaves_batched`, its plain
    version on CPU tensors): each cell bitwise the plain version and the
    one-cell entry on its own slots, zero-weight and single-slot cells too;
  * the batched leader (`leader_round_cells`, `make_group_leader`): each
    cell bitwise `leader_round` alone, for every (ds, sa) and for a mixed
    group, with cells that end their loops at different iterations; the
    batch reads the host as often as its slowest cell alone;
  * `run_many` groups of 3-6 cells (seeds x policies, static / churn;
    sync, async, async_const, async_full and a mixed async group) bitwise
    their solo runs, async_full bitwise the scan group;
  * the host-read bound: a group round reads at most, over its distinct
    policies, the most any of that policy's cells reads alone, plus one;
  * a group against the JAX package's vmapped `run_many` with the JAX
    draws injected: traces exact, losses within 1e-4;
  * a group of one bitwise the one-cell APIs (`sync_cell_round`, and
    `build_async_runner`, which the service calls).
"""
from _torch_oracle import SMALL, inject_jax_draws, rel_err  # noqa: I001  (alias first)

import dataclasses
import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RoundPolicy as JaxPolicy
from repro.core import leader_jax
from repro.fl import SimConfig as JaxSimConfig
from repro.fl import run_many as jax_run_many
from repro_torch.core import RoundPolicy, leader_torch
from repro_torch.fl import SimConfig, run_many, run_simulation, sim
from repro_torch.fl.async_loop import build_async_runner
from repro_torch.fl.engine_common import (make_eval_fn, make_group_leader,
                                          make_leader_branches, make_xs, sync_cell_round)
from repro_torch.kernels.fedavg_agg import (fedavg_agg_plain, fedavg_aggregate_leaves,
                                            fedavg_aggregate_leaves_batched)
from repro_torch.kernels.fedavg_agg.ops import CELL_ALIGN
from repro_torch.scenarios import apply_dynamics

CPU = torch.device("cpu")
POLICIES = list(itertools.product(("alg3", "aou_topk", "random", "cluster", "fixed"),
                                  ("matching", "random")))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors (as
    tests/test_torch_hier.py): beside other test workers, torch's default
    oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(**kw) -> SimConfig:
    return SimConfig(**dict(SMALL, **kw))


def _assert_bitwise(a, b, what=""):
    """Every field of two histories but the wall times equal to the bit,
    the async engine's commit and pending traces included."""
    for f in dataclasses.fields(a):
        if f.name in ("wall_s", "plan_wall_s"):
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, dict):
            assert x.keys() == y.keys(), f.name
            for key in x:
                np.testing.assert_array_equal(x[key], y[key], err_msg=f"{what} {f.name}.{key}")
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {f.name}")
        else:
            assert x == y, f"{what} {f.name}"


# --------------------------------------------------------------------------
# K3 with a cell axis
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cells", [1, 3, 5])
def test_k3_cells_bitwise_per_cell(cells):
    """Random, all-zero and single-slot cells: each cell's means are the
    plain version's and the one-cell entry's bits; every (cell, leaf) view
    is contiguous and starts on a CELL_ALIGN boundary."""
    rng = np.random.default_rng(cells)
    k = 4
    shapes = [(7, 5), (10,), (3, 2, 2)]
    stacked = [torch.from_numpy(rng.normal(size=(cells, k) + s).astype(np.float32))
               for s in shapes]
    w = torch.from_numpy(rng.uniform(1, 50, (cells, k)).astype(np.float32))
    if cells > 1:
        w[1] = 0.0
    if cells > 2:
        w[2] = torch.tensor([0.0, 0.0, 7.0, 0.0])
    got = fedavg_aggregate_leaves_batched(stacked, w)
    base = got[0].untyped_storage().data_ptr()
    for c in range(cells):
        one = fedavg_aggregate_leaves([x[c] for x in stacked], w[c])
        for g, x, o in zip(got, stacked, one):
            want = fedavg_agg_plain(x[c], w[c])
            assert torch.equal(g[c], want) and torch.equal(g[c], o)
            assert g[c].is_contiguous()
            assert (g[c].data_ptr() - base) % (4 * CELL_ALIGN) == 0
            if c == 1:
                assert not g[c].any()
            if c == 2:
                assert torch.equal(g[c], x[c][2])


def test_k3_cells_takes_no_other_device():
    x = torch.zeros((2, 3, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fedavg_aggregate_leaves_batched([x], torch.zeros((2, 3), device="meta"))


# --------------------------------------------------------------------------
# the batched leader
# --------------------------------------------------------------------------

N, K = 12, 4
_LEADER_KEYS = ("age", "beta", "gamma", "feasible", "sel_perm", "assign_perm")


def _leader_cell(seed: int, infeasible: float) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        age=torch.from_numpy(rng.integers(1, 8, N).astype(np.int32)),
        beta=torch.from_numpy(rng.integers(5, 60, N).astype(np.float32)),
        gamma=torch.from_numpy((rng.exponential(size=(K, N)) * 5).astype(np.float32)),
        feasible=torch.from_numpy(rng.uniform(size=(K, N)) > infeasible),
        sel_perm=torch.from_numpy(rng.permutation(N)),
        assign_perm=torch.from_numpy(rng.permutation(K)),
        clusters=torch.from_numpy((np.arange(N) % 3).astype(np.int64)),
        fixed_ids=torch.from_numpy(rng.permutation(N)[:K]))


_DRAWS = [(0, 0.5), (1, 0.5), (4, 0.85), (5, 0.85), (9, 0.2), (3, 0.6)]


def _solo(cell: dict, ds: str, sa: str, **kw) -> tuple[dict, int]:
    before = leader_torch.host_int.syncs
    out = leader_torch.leader_round(*(cell[k] for k in _LEADER_KEYS), 2, cell["clusters"],
                                    cell["fixed_ids"], ds=ds, sa=sa, k=K, n=N, n_clusters=3,
                                    **kw)
    return out, leader_torch.host_int.syncs - before


def _assert_rows(got: dict, solo: list):
    """Each cell's row of the batched lead dict equals its solo dict."""
    for i, (want, _) in enumerate(solo):
        for name, v in want.items():
            row = got[name][i]
            assert row == v if name == "iterations" else torch.equal(row, v), (i, name)


def _batched(cells: list, ds: str, sa: str, **kw) -> tuple[dict, int]:
    st = {k: torch.stack([c[k] for c in cells]) for k in cells[0]}
    before = leader_torch.host_int.syncs
    got = leader_torch.leader_round_cells(
        *(st[k] for k in _LEADER_KEYS), 2, st["clusters"], st["fixed_ids"],
        ds=ds, sa=sa, k=K, n=N, n_clusters=3, **kw)
    return got, leader_torch.host_int.syncs - before


@pytest.mark.parametrize("ds,sa", POLICIES, ids=[f"{d}-{s}" for d, s in POLICIES])
def test_leader_cells_bitwise_per_cell(ds, sa):
    cells = [_leader_cell(s, inf) for s, inf in _DRAWS]
    solo = [_solo(c, ds, sa) for c in cells]
    got, reads = _batched(cells, ds, sa)
    _assert_rows(got, solo)
    solo_reads = [r for _, r in solo]
    assert reads == max(solo_reads)
    if sa == "matching" or ds == "alg3":
        assert len(set(solo_reads)) > 1          # cells end at different iterations


@pytest.mark.parametrize("max_rounds", [1, 2])
@pytest.mark.parametrize("ds", ["alg3", "random"])
def test_leader_cells_at_the_round_cap(ds, max_rounds):
    """Algorithm 2 stopped by `max_rounds` (a matching still blocked, its
    cell frozen; Algorithm 3 deciding on the next step): each cell bitwise
    alone, and alone as the JAX package's `leader_round` decides."""
    cells = [_leader_cell(s, inf) for s, inf in _DRAWS]
    solo = [_solo(c, ds, "matching", max_rounds=max_rounds) for c in cells]
    got, _ = _batched(cells, ds, "matching", max_rounds=max_rounds)
    _assert_rows(got, solo)
    for c, (mine, _) in zip(cells, solo):
        want = leader_jax.leader_round(
            *(jnp.asarray(c[k].numpy()) for k in _LEADER_KEYS), 2,
            jnp.asarray(c["clusters"].numpy()), jnp.asarray(c["fixed_ids"].numpy()),
            ds=ds, sa="matching", k=K, n=N, n_clusters=3, max_rounds=max_rounds)
        for name in ("selected", "transmitted", "channel_of", "age_next"):
            np.testing.assert_array_equal(mine[name].numpy(), np.asarray(want[name]),
                                          err_msg=name)
        assert mine["iterations"] == int(want["iterations"])


def test_mixed_policy_group_leader():
    """`make_group_leader` over a group sorted by policy: each run of one
    policy is one batched leader call; each cell bitwise alone; the group
    reads, per policy, as often as that policy's slowest cell."""
    policies = [("alg3", "matching"), ("random", "matching"), ("alg3", "random")]
    pol_idx = [0, 0, 1, 1, 1, 2]
    cells = [_leader_cell(s, inf) for s, inf in _DRAWS]
    data = dict(beta=torch.stack([c["beta"] for c in cells]),
                clusters=torch.stack([c["clusters"] for c in cells]),
                fixed_ids=torch.stack([c["fixed_ids"] for c in cells]),
                spans=[(0, 0, 2), (1, 2, 5), (2, 5, 6)])
    x = dict(gamma=torch.stack([c["gamma"] for c in cells]),
             sel_perm=torch.stack([c["sel_perm"] for c in cells]),
             assign_perm=torch.stack([c["assign_perm"] for c in cells]), t=2)
    lead = make_group_leader(policies, data, k=K, n=N, n_clusters=3)
    before = leader_torch.host_int.syncs
    got = lead(torch.stack([c["age"] for c in cells]),
               torch.stack([c["feasible"] for c in cells]), x)
    reads = leader_torch.host_int.syncs - before
    solo = [_solo(c, *policies[p]) for c, p in zip(cells, pol_idx)]
    _assert_rows(got, solo)
    assert reads == sum(max(solo[i][1] for i in range(a, b)) for _, a, b in data["spans"])


# --------------------------------------------------------------------------
# run_many groups, bitwise their solo runs
# --------------------------------------------------------------------------

def _group(engine: str, cfgs: list, monkeypatch) -> list:
    """run_many on the CPU, checking that the cells ran as ONE group."""
    sizes = []
    run_group = sim._run_group

    def spy(mode, cfgs, *args):
        sizes.append(len(cfgs))
        return run_group(mode, cfgs, *args)

    monkeypatch.setattr(sim, "_run_group", spy)
    out = run_many(cfgs, engine=engine, device="cpu")
    assert sizes == [len(cfgs)]
    return out


GROUPS = {
    "scan-static-6": ("scan", "static", "sync",
                      [(0, ("alg3", "mo", "matching")), (1, ("random", "mo", "random")),
                       (0, ("cluster", "fix", "matching")), (1, ("alg3", "mo", "matching")),
                       (0, ("random", "mo", "random")), (1, ("fixed", "mo", "matching"))]),
    "scan-churn-4": ("scan", "churn", "sync",
                     [(s, p) for s in (0, 1) for p in (("alg3", "mo", "matching"),
                                                       ("aou_topk", "fix", "random"))]),
    "async-churn-4": ("async", "churn", "async",
                      [(s, p) for s in (0, 1) for p in (("alg3", "mo", "matching"),
                                                        ("random", "mo", "matching"))]),
    "async_const-static-3": ("async", "static", "async_const",
                             [(0, ("alg3", "mo", "matching")), (1, ("cluster", "mo", "random")),
                              (2, ("alg3", "mo", "matching"))]),
    "async_full-churn-3": ("async", "churn", "async_full",
                           [(0, ("alg3", "mo", "matching")), (1, ("alg3", "mo", "matching")),
                            (0, ("fixed", "fix", "matching"))]),
    "async-mixed-4": ("async", "urban", None,
                      [(0, ("alg3", "mo", "matching")), (1, ("alg3", "mo", "matching")),
                       (0, ("random", "mo", "random")), (1, ("alg3", "mo", "matching"))]),
}
MIXED_AGGREGATIONS = ["async", "async_const", "async_full", "sync"]


@pytest.mark.parametrize("name", list(GROUPS))
def test_group_cells_bitwise_solo(monkeypatch, name):
    engine, scenario, aggregation, cells = GROUPS[name]
    cfgs = [_cfg(seed=s, policy=RoundPolicy(*p), scenario=scenario,
                 aggregation=aggregation or MIXED_AGGREGATIONS[i])
            for i, (s, p) in enumerate(cells)]
    hists = _group(engine, cfgs, monkeypatch)
    for i, (c, h) in enumerate(zip(cfgs, hists)):
        assert h.tx_trace.any()
        _assert_bitwise(h, run_simulation(c, engine=engine, device="cpu"), f"cell {i}")
    if engine == "async" and aggregation != "async_full":   # a buffer that waits
        assert any(h.async_trace["n_pending"].max() > 0 for h in hists)


def test_async_full_group_bitwise_scan_group(monkeypatch):
    cells = [(0, ("alg3", "mo", "matching")), (1, ("random", "mo", "matching")),
             (1, ("cluster", "fix", "random"))]
    scan = _group("scan", [_cfg(seed=s, policy=RoundPolicy(*p), scenario="churn")
                           for s, p in cells], monkeypatch)
    full = run_many([_cfg(seed=s, policy=RoundPolicy(*p), scenario="churn",
                          aggregation="async_full") for s, p in cells], device="cpu")
    for a, b in zip(scan, full):
        for f in dataclasses.fields(a):
            if f.name not in ("wall_s", "plan_wall_s", "commit_trace", "async_trace"):
                np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name),
                                              err_msg=f.name)
        np.testing.assert_array_equal(b.commit_trace, a.tx_trace)


def test_group_host_reads_bound(monkeypatch):
    """Per round, a mixed-policy group reads the host at most, over its
    distinct policies, the most reads any of that policy's cells makes in
    its own leader step, plus one (who trains) — where one cell after
    another read the sum over the cells."""
    reads: list[int] = []
    round_body = sim.sync_group_round

    def counted(*args, **kw):
        before = leader_torch.host_int.syncs
        out = round_body(*args, **kw)
        reads.append(leader_torch.host_int.syncs - before)
        return out

    monkeypatch.setattr(sim, "sync_group_round", counted)
    pols = [("alg3", "mo", "matching"), ("random", "mo", "matching"),
            ("alg3", "mo", "random")]
    cfgs = [_cfg(seed=s, policy=RoundPolicy(*p), n_devices=12, n_subchannels=4)
            for s in (0, 1) for p in pols]
    run_many(cfgs, engine="scan", device="cpu")
    group = list(reads)
    solo = []
    for c in cfgs:
        reads.clear()
        run_simulation(c, engine="scan", device="cpu")
        solo.append(list(reads))
    assert len(group) == cfgs[0].rounds and all(len(s) == len(group) for s in solo)
    for r, g in enumerate(group):
        bound = 1 + sum(max(solo[i][r] - 1 for i, c in enumerate(cfgs)
                            if c.policy.ds == p[0] and c.policy.sa == p[2]) for p in pols)
        assert g <= bound, (r, g, bound)
    assert sum(group) < sum(map(sum, solo))


# --------------------------------------------------------------------------
# against the JAX package's vmapped run_many
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine,aggregation", [("scan", "sync"), ("async", "async")])
def test_group_matches_jax_run_many(monkeypatch, engine, aggregation):
    inject_jax_draws(monkeypatch)
    cells = [(0, ("alg3", "mo", "matching")), (1, ("random", "mo", "random")),
             (1, ("cluster", "mo", "matching"))]
    kw = dict(scenario="churn", aggregation=aggregation)
    got = run_many([_cfg(seed=s, policy=RoundPolicy(*p), **kw) for s, p in cells],
                   engine=engine, device="cpu")
    want = jax_run_many([JaxSimConfig(**SMALL, seed=s, policy=JaxPolicy(*p), **kw)
                         for s, p in cells], engine=engine, ra_backend="bisect")
    for g, w in zip(got, want):
        for name in ("tx_trace", "age_trace", "n_selected", "n_transmitted", "rounds"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=name)
        if engine == "async":
            np.testing.assert_array_equal(g.commit_trace, w.commit_trace)
            np.testing.assert_array_equal(g.async_trace["n_pending"],
                                          w.async_trace["n_pending"])
        for name in ("latency_all", "energy_all", "cum_time_s"):
            assert rel_err(getattr(g, name), getattr(w, name)) < 1e-6, name
        assert rel_err(g.global_loss, w.global_loss) < 1e-4


# --------------------------------------------------------------------------
# a group of one and the one-cell APIs
# --------------------------------------------------------------------------

def _world(cfg):
    prep = sim._prepare(cfg, CPU)
    (ra,), _ = sim._solve_horizons([prep], "fused", CPU)
    ra = apply_dynamics(ra, prep.avail, prep.slowdown, prep.beta, prep.wcfg)
    model, trainer, policies, _ = sim._group_trainer_and_policies([cfg], CPU)
    return sim._scan_inputs(prep, ra, CPU), model, trainer, policies


def test_group_of_one_is_the_cell_round():
    """run_simulation(engine="scan") against a host loop of
    `sync_cell_round`, the one-cell round."""
    cfg = _cfg(scenario="churn", policy=RoundPolicy("alg3", "mo", "matching"))
    hist = run_simulation(cfg, engine="scan", device="cpu")
    d, model, trainer, policies = _world(cfg)
    k, n = cfg.n_subchannels, cfg.n_devices
    leader = make_leader_branches(policies, d, k=k, n=n, n_clusters=math.ceil(n / k))
    ev = make_eval_fn(model, d, False)
    xs = make_xs(d, cfg.rounds, sim._eval_mask(cfg))
    params, age = d["params0"], torch.ones(n, dtype=torch.int32)
    tx, ages, lat, energy, loss = [], [], [], [], []
    for r in range(cfg.rounds):
        out = sync_cell_round(leader, trainer, d, {name: v[r] for name, v in xs.items()},
                              params, d["next_uniforms"], age, k=k, n=n)
        params, age = out["params"], out["lead"]["age_next"]
        tx.append(out["lead"]["transmitted"].numpy())
        ages.append(age.numpy())
        lat.append(float(out["latency"]))
        energy.append(float(out["energy"]))
        if xs["eval_mask"][r]:
            loss.append(float(ev(params)[0]))
    np.testing.assert_array_equal(hist.tx_trace, np.stack(tx))
    np.testing.assert_array_equal(hist.age_trace, np.stack(ages))
    np.testing.assert_array_equal(hist.latency_all, np.asarray(lat))
    np.testing.assert_array_equal(hist.energy_all, np.asarray(energy))
    np.testing.assert_array_equal(hist.global_loss, np.asarray(loss))


def test_group_of_one_is_the_cell_runner():
    """run_simulation(aggregation="async") against `build_async_runner`,
    the one-cell event loop the service calls."""
    cfg = _cfg(scenario="churn", aggregation="async")
    hist = run_simulation(cfg, device="cpu")
    d, model, trainer, policies = _world(cfg)
    spec = sim._async_spec(cfg)
    d.update(buffer=spec.resolve_buffer(cfg.n_devices, cfg.n_subchannels),
             stale_exp=torch.tensor(spec.stale_exponent()),
             server_lr=torch.tensor(spec.server_lr))
    ys = build_async_runner(model, trainer, policies, k=cfg.n_subchannels,
                            n=cfg.n_devices, rounds=cfg.rounds,
                            eval_mask=sim._eval_mask(cfg))(d)
    want = sim._history_from_async(cfg, hist.beta, sim._to_host(ys), 0.0, 0.0)
    _assert_bitwise(hist, want)
