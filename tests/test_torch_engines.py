"""The port's device engines (`engine="scan"`, `engine="async"`) on the CPU.

Three contracts:

  * port scan vs port loop, over all 20 RoundPolicy combinations — the JAX
    package's own scan contract (tests/test_scan_equivalence.py): tx, AoU
    and selection counts exact; latency and energy within 1e-5 relative,
    because the device leader plane runs in float32 while the loop engine
    keeps float64; loss within 1e-3;
  * port scan / async vs the JAX package's scan / async engines, with the
    JAX draws injected: every trace exact (tx, AoU, commits, pending
    counts, overflow), latency and dispatch clocks within 1e-6 relative
    (both sides cast the same float64 Γ to float32), losses within 1e-4
    (float32 training whose sums the frameworks order differently);
  * the full-buffer limit: `aggregation="async_full"` (and a "sync" cell
    forced through the event engine) is bitwise the port's scan run.
"""
from _torch_oracle import SMALL, inject_jax_draws, rel_err  # noqa: I001  (alias first)

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RoundPolicy as JaxPolicy
from repro.fl import SimConfig as JaxSimConfig
from repro.fl import run_simulation as jax_run_simulation
from repro.fl.async_loop import commit_event as jax_commit_event
from repro_torch.core import RoundPolicy
from repro_torch.fl import SimConfig, run_many, run_simulation
from repro_torch.fl import sim
from repro_torch.fl.async_loop import build_async_runner, commit_event, init_async_carry
from repro_torch.scenarios import apply_dynamics

COMBOS = list(itertools.product(("alg3", "aou_topk", "random", "cluster", "fixed"),
                                ("mo", "fix"), ("matching", "random")))
CPU = torch.device("cpu")


def _cfg(**kw) -> SimConfig:
    return SimConfig(**dict(SMALL, **kw))


def _assert_bitwise(a, b):
    """Every per-round field of two histories equal to the bit."""
    for f in dataclasses.fields(a):
        if f.name in ("wall_s", "plan_wall_s", "commit_trace", "async_trace"):
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("ds,ra,sa", COMBOS, ids=[f"{d}-{r}-{s}" for d, r, s in COMBOS])
def test_scan_matches_loop_all_policies(ds, ra, sa):
    cfg = _cfg(policy=RoundPolicy(ds=ds, ra=ra, sa=sa))
    a = run_simulation(cfg, engine="loop", device="cpu")
    b = run_simulation(cfg, engine="scan", device="cpu")
    np.testing.assert_array_equal(a.tx_trace, b.tx_trace)
    np.testing.assert_array_equal(a.age_trace, b.age_trace)
    np.testing.assert_array_equal(a.n_selected, b.n_selected)
    np.testing.assert_array_equal(a.n_transmitted, b.n_transmitted)
    np.testing.assert_allclose(b.latency_all, a.latency_all, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(b.energy_all, a.energy_all, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(b.cum_time_s, a.cum_time_s, rtol=1e-5)
    np.testing.assert_allclose(b.deficits, a.deficits, rtol=1e-6)
    np.testing.assert_allclose(b.global_loss, a.global_loss, rtol=1e-3)


def _against_jax(monkeypatch, engine: str, **kw):
    inject_jax_draws(monkeypatch)
    pol = kw.pop("policy", ("alg3", "mo", "matching"))
    got = run_simulation(_cfg(**kw, policy=RoundPolicy(*pol)), engine=engine,
                         device="cpu")
    want = jax_run_simulation(JaxSimConfig(**SMALL, **kw, policy=JaxPolicy(*pol)),
                              engine=engine, ra_backend="bisect")
    for name in ("tx_trace", "age_trace", "n_selected", "n_transmitted", "rounds"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert got.tx_trace.any()
    for name in ("latency_all", "energy_all", "cum_time_s"):
        assert rel_err(getattr(got, name), getattr(want, name)) < 1e-6, name
    assert rel_err(got.global_loss, want.global_loss) < 1e-4
    np.testing.assert_allclose(got.accuracy, want.accuracy, rtol=1e-4, atol=0)
    return got, want


@pytest.mark.parametrize("policy,scenario", [
    (("alg3", "mo", "matching"), "static"),
    (("aou_topk", "fix", "matching"), "churn"),
    (("cluster", "mo", "random"), "static"),
    (("random", "mo", "matching"), "churn"),
])
def test_scan_matches_jax_scan(monkeypatch, policy, scenario):
    _against_jax(monkeypatch, "scan", policy=policy, scenario=scenario)


@pytest.mark.parametrize("aggregation", ["async", "async_const", "async_full"])
@pytest.mark.parametrize("scenario", ["churn", "static"])
def test_async_matches_jax_async(monkeypatch, aggregation, scenario):
    got, want = _against_jax(monkeypatch, "async", aggregation=aggregation,
                             scenario=scenario)
    np.testing.assert_array_equal(got.commit_trace, want.commit_trace)
    for name in ("n_pending", "overflow"):
        np.testing.assert_array_equal(got.async_trace[name], want.async_trace[name],
                                      err_msg=name)
    assert rel_err(got.async_trace["rem_dispatch"],
                   want.async_trace["rem_dispatch"]) < 1e-6
    assert not got.async_trace["overflow"].any()


@pytest.mark.parametrize("scenario", ["churn", "static"])
def test_full_buffer_is_bitwise_scan(scenario):
    scan = run_simulation(_cfg(scenario=scenario), engine="scan", device="cpu")
    for asy in (run_simulation(_cfg(scenario=scenario, aggregation="async_full"),
                               device="cpu"),
                run_simulation(_cfg(scenario=scenario), engine="async", device="cpu")):
        _assert_bitwise(scan, asy)
        np.testing.assert_array_equal(asy.commit_trace, scan.tx_trace)
        assert asy.async_trace["n_pending"].max() == 0


def test_async_aggregation_routes_whatever_the_engine():
    cfgs = [_cfg(aggregation="async", scenario="churn"), _cfg(scenario="churn")]
    by_engine = [run_many(cfgs, engine=e, device="cpu") for e in ("loop", "scan", "async")]
    for hists in by_engine[1:]:
        _assert_bitwise(by_engine[0][0], hists[0])
        np.testing.assert_array_equal(by_engine[0][0].commit_trace, hists[0].commit_trace)
    assert by_engine[0][1].commit_trace is None           # sync cell, loop engine
    assert by_engine[2][1].commit_trace is not None       # forced through events
    _assert_bitwise(by_engine[1][1], by_engine[2][1])


@pytest.mark.parametrize("buffer", [1, 2, 3, 10])
def test_commit_event_matches_jax(buffer):
    """The commit decision on float32 clocks with many exact ties, so more
    than K uploads land together and the (rem, id) cap at K decides."""
    rng = np.random.default_rng(buffer)
    n, k = 10, 4
    for _ in range(20):
        rem = rng.choice(np.float32([0.5, 1.25, 1.25, 3.0]), n).astype(np.float32)
        active = rng.uniform(size=n) < 0.8
        delta, commit = commit_event(torch.from_numpy(rem), torch.from_numpy(active),
                                     buffer, k)
        w_delta, w_commit = jax_commit_event(jnp.asarray(rem), jnp.asarray(active),
                                             jnp.int32(buffer), k)
        assert delta.item() == float(w_delta)
        np.testing.assert_array_equal(commit.numpy(), np.asarray(w_commit))
        assert commit.sum() <= k


def test_segmented_async_replays_one_run():
    """Two segments of 3 events, the carry threaded between them, give the
    run of 6 events bit for bit (absolute event index through t0)."""
    cfg = _cfg(aggregation="async", scenario="churn")
    prep = sim._prepare(cfg, CPU)
    (ra,), _ = sim._solve_horizons([prep], "fused", CPU)
    ra = apply_dynamics(ra, prep.avail, prep.slowdown, prep.beta, prep.wcfg)
    model, trainer, policies, _ = sim._group_trainer_and_policies([cfg], CPU)
    spec = sim._async_spec(cfg)

    def data():
        d = sim._scan_inputs(prep, ra, CPU)
        d.update(buffer=spec.resolve_buffer(cfg.n_devices, cfg.n_subchannels),
                 stale_exp=torch.tensor(spec.stale_exponent()),
                 server_lr=torch.tensor(spec.server_lr))
        return d

    kw = dict(k=cfg.n_subchannels, n=cfg.n_devices)
    mask = sim._eval_mask(cfg)
    whole = build_async_runner(model, trainer, policies, rounds=cfg.rounds,
                               eval_mask=mask, **kw)(data())
    d = data()
    carry = init_async_carry(d["params0"], d["next_uniforms"], cfg.n_devices)
    parts = []
    for t0 in (0, 3):
        seg = {**d, "t0": t0}
        for name in ("gamma", "feas", "energy", "sel_perms", "assign_perms"):
            seg[name] = d[name][t0:t0 + 3]
        run = build_async_runner(model, trainer, policies, rounds=3,
                                 eval_mask=mask[t0:t0 + 3], segmented=True, **kw)
        carry, ys = run(seg, carry)
        parts.append(ys)
    for name, v in whole.items():
        torch.testing.assert_close(torch.cat([p[name] for p in parts]), v,
                                   rtol=0, atol=0, msg=name)
    assert whole["committed"].any() and whole["n_pending"].max() > 0
