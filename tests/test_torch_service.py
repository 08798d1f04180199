"""The port's sustained service (`repro_torch.service`) and its scenario
stream (`repro_torch.scenarios.ScenarioStream`) on the CPU, against the
JAX package.

  * `ScenarioStream`: segments bitwise equal to the JAX package's for every
    preset and two split patterns, and to one unsplit segment;
  * the segment-resume contract: three chained segments of 4 events
    bitwise equal to one segment of 12, on every per-event key;
  * `SustainedService` against the JAX package's with its draws injected
    (`inject_jax_draws`; JAX Γ through `ra_backend="bisect"`), for
    `ra="fix"` and `ra="mo"`, two segments: latency, pending count, AoU,
    commits and dispatches exact; loss within the port's mnist tolerance
    (1e-4 relative, tests/test_torch_sim.py), accuracy within rtol 1e-4;
  * `ServiceConfig` refusing what the JAX package's refuses, the `serve()`
    record with the JAX package's keys, and the observability arithmetic
    equal to the JAX package's on a hand-built log;
  * the CLI, `python -m repro_torch.service.run --smoke --device cpu`.
"""
from _torch_oracle import inject_jax_draws, rel_err  # noqa: I001  (alias first)

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import RoundPolicy as JaxPolicy
from repro.fl.sim import SimConfig as JaxSimConfig
from repro.scenarios import ScenarioStream as JaxStream
from repro.service import EventLog as JaxEventLog
from repro.service import ServiceConfig as JaxServiceConfig
from repro.service import SustainedService as JaxService
from repro.service import latency_percentiles as jax_latency_percentiles
from repro.service import slo_attainment as jax_slo_attainment
from repro.service import summarize as jax_summarize
from repro_torch.core import RoundPolicy
from repro_torch.fl import SimConfig
from repro_torch.scenarios import PRESETS, ScenarioStream
from repro_torch.service import (EventLog, ServiceConfig, SustainedService,
                                 latency_percentiles, slo_attainment, summarize,
                                 throughput_events_per_s)

ROOT = Path(__file__).resolve().parent.parent
_SIM = dict(dataset="mnist", n_devices=8, n_subchannels=3, n_samples=96, batch=16,
            local_steps=1, scenario="churn", aggregation="async")
_YS_KEYS = ("loss", "acc", "gnorm", "latency", "energy", "selected", "transmitted",
            "age", "committed", "n_pending", "overflow", "rem_dispatch")
_TRACE_FIELDS = ("h2_all", "distances_m", "avail", "slowdown", "e_max_j")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors (as the
    hierarchy's test files pin it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _service(ra="fix", segment_events=4, eval_every=2, **kw) -> SustainedService:
    return SustainedService(ServiceConfig(
        sim=SimConfig(**_SIM, policy=RoundPolicy(ra=ra)), segment_events=segment_events,
        eval_every_events=eval_every, **kw), device="cpu")


def _jax_service(ra="fix", segment_events=4, eval_every=2, **kw) -> JaxService:
    return JaxService(JaxServiceConfig(
        sim=JaxSimConfig(**_SIM, policy=JaxPolicy(ra=ra)), segment_events=segment_events,
        eval_every_events=eval_every, **kw), ra_backend="bisect")


# ---------------------------------------------------------------------------
# ScenarioStream
# ---------------------------------------------------------------------------

SPLITS = [(3, 4, 5), (1, 1, 10)]


@pytest.mark.parametrize("split", SPLITS, ids=["3-4-5", "1-1-10"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_scenario_stream_bitwise_jax(preset, split):
    wcfg = SimConfig(**_SIM).wireless()
    jwcfg = JaxSimConfig(**_SIM).wireless()
    port, jax_stream = ScenarioStream(7, wcfg, preset), JaxStream(7, jwcfg, preset)
    parts = [port.next_segment(r) for r in split]
    jparts = [jax_stream.next_segment(r) for r in split]
    whole = ScenarioStream(7, wcfg, preset).next_segment(sum(split))
    for p, j in zip(parts, jparts):
        for field in _TRACE_FIELDS:
            got, want = getattr(p, field), getattr(j, field)
            assert got.dtype == want.dtype, (preset, field)
            np.testing.assert_array_equal(got, want, err_msg=f"{preset} {field}")
    for field in _TRACE_FIELDS:
        np.testing.assert_array_equal(
            np.concatenate([getattr(p, field) for p in parts]), getattr(whole, field),
            err_msg=f"{preset} {field} segmentation")
    assert port.t == sum(split)


def test_scenario_stream_refuses_an_empty_segment():
    with pytest.raises(ValueError, match=">= 1 round"):
        ScenarioStream(0, SimConfig(**_SIM).wireless(), "static").next_segment(0)


# ---------------------------------------------------------------------------
# the segment-resume contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ra", ["fix", "mo"])
def test_chained_segments_bitwise_one_segment(ra):
    one = _service(ra, segment_events=12, eval_every=2)
    ys_one = one.run_segment()
    chained = _service(ra, segment_events=4, eval_every=2)
    parts = [chained.run_segment() for _ in range(3)]
    assert chained.events_served == one.events_served == 12
    assert set(ys_one) == set(_YS_KEYS)
    for k in _YS_KEYS:
        np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), ys_one[k],
                                      err_msg=k)
    assert ys_one["committed"].any() and ys_one["n_pending"].max() > 0


def test_step_solver_matches_fused():
    """ra_solver="step" (the step driver; K2 on the card) gives the fused
    solve's segment (K1 on the card) event for event."""
    fused = _service("mo", segment_events=8, eval_every=4).run_segment()
    step = SustainedService(ServiceConfig(
        sim=SimConfig(**_SIM, policy=RoundPolicy(ra="mo")), segment_events=8,
        eval_every_events=4), ra_solver="step", device="cpu").run_segment()
    for k in ("transmitted", "committed", "age", "n_pending"):
        np.testing.assert_array_equal(step[k], fused[k], err_msg=k)
    assert rel_err(step["latency"], fused["latency"]) < 1e-6


# ---------------------------------------------------------------------------
# against the JAX package's service
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ra", ["fix", "mo"])
def test_service_matches_jax(monkeypatch, ra):
    inject_jax_draws(monkeypatch)
    port, jax_svc = _service(ra, segment_events=8, eval_every=4), _jax_service(
        ra, segment_events=8, eval_every=4)
    for seg in range(2):
        got, want = port.run_segment(), jax_svc.run_segment()
        for k in ("latency", "n_pending", "age", "committed", "transmitted", "selected",
                  "overflow"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=f"segment {seg} {k}")
        ev = np.nonzero(want["loss"])[0]
        assert ev.tolist() == [3, 7]
        assert rel_err(got["loss"][ev], want["loss"][ev]) < 1e-4
        np.testing.assert_allclose(got["acc"][ev], want["acc"][ev], rtol=1e-4, atol=0)
        assert got["transmitted"].any()
    assert port.events_served == jax_svc.events_served == 16


BAD_CONFIGS = {
    "eval-divides": (dict(segment_events=10, eval_every_events=3), "divide"),
    "eval-positive": (dict(segment_events=10, eval_every_events=0), "divide"),
    "segment": (dict(segment_events=0), "segment_events"),
    "rate": (dict(target_rate_events_per_s=0.0), "positive"),
    "budget": (dict(latency_budget_s=-1.0), "budget"),
    "warmup": (dict(warmup_segments=-1), "warmup"),
}


@pytest.mark.parametrize("kw,match", list(BAD_CONFIGS.values()), ids=list(BAD_CONFIGS))
def test_service_config_refuses_like_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        JaxServiceConfig(sim=JaxSimConfig(**_SIM), **kw)
    with pytest.raises(ValueError, match=match):
        ServiceConfig(sim=SimConfig(**_SIM), **kw)


def test_service_refusals():
    cfg = ServiceConfig(sim=SimConfig(**_SIM), segment_events=4)
    with pytest.raises(ValueError, match="ra_solver"):
        SustainedService(cfg, ra_solver="newton", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SustainedService(cfg)
    svc = SustainedService(cfg, device="cpu")
    with pytest.raises(ValueError, match="n_segments"):
        svc.serve(0)
    svc._events_served = 2 ** 24       # the f32 priority products' limit
    with pytest.raises(ValueError, match="2\\^24"):
        svc.run_segment()


def _keys(obj, prefix=""):
    if isinstance(obj, dict):
        return {p for k, v in obj.items() for p in _keys(v, f"{prefix}/{k}")} | {prefix}
    return {prefix}


def test_serve_record_has_jax_keys():
    kw = dict(segment_events=4, eval_every=2, warmup_segments=1, latency_budget_s=60.0)
    rec = _service(**kw).serve(2)
    want = _jax_service(**kw).serve(2)
    assert _keys(rec) == _keys(want)
    assert rec["schema"] == want["schema"] == 1 and rec["kind"] == "sustained_service"
    assert rec["service"] == want["service"]
    for name in ("event", "n_pending", "mean_age", "sim_latency_s"):
        assert rec["events"][name] == want["events"][name], name
    assert rec["steady_state"]["event"] == want["steady_state"]["event"] == [5, 7, 9, 11]
    assert rec["service"]["events_measured"] == 8
    assert rec["service"]["events_served_total"] == 12
    s = rec["summary"]
    assert s["events"] == 8 and s["throughput_events_per_s"] > 0
    assert s["slo"]["attained"] == 1.0
    assert s["buffer"] == want["summary"]["buffer"]
    json.dumps(rec)


# ---------------------------------------------------------------------------
# observability: the same arithmetic as the JAX package's
# ---------------------------------------------------------------------------

def _log_arrays(seed: int):
    rng = np.random.default_rng(seed)
    arrival = np.cumsum(rng.exponential(0.1, 200))
    return dict(arrival_s=arrival, complete_s=arrival + rng.exponential(0.5, 200),
                sim_latency_s=rng.exponential(2.0, 200),
                n_pending=rng.integers(0, 6, 200))


@pytest.mark.parametrize("seed", [0, 1])
def test_observability_equals_jax(seed):
    arrays = _log_arrays(seed)
    log, jlog = EventLog(**arrays), JaxEventLog(**arrays)
    lat = log.latencies_s()
    np.testing.assert_array_equal(lat, jlog.latencies_s())
    assert latency_percentiles(lat) == jax_latency_percentiles(lat)
    for budget in (0.1, 0.5, 2.0):
        assert slo_attainment(lat, budget) == jax_slo_attainment(lat, budget)
        assert summarize(log, budget) == jax_summarize(jlog, budget)
    assert throughput_events_per_s(log) == summarize(log, 1.0)["throughput_events_per_s"]


BAD_LOGS = {
    "lengths": (dict(arrival_s=np.zeros(3), complete_s=np.zeros(2),
                     sim_latency_s=np.zeros(3), n_pending=np.zeros(3)), "equal-length"),
    "order": (dict(arrival_s=np.array([1.0, 0.0]), complete_s=np.array([2.0, 2.0]),
                   sim_latency_s=np.zeros(2), n_pending=np.zeros(2)), "non-decreasing"),
    "causal": (dict(arrival_s=np.array([0.0, 2.0]), complete_s=np.array([1.0, 1.0]),
                    sim_latency_s=np.zeros(2), n_pending=np.zeros(2)), "complete before"),
    "empty": (dict(arrival_s=np.zeros(0), complete_s=np.zeros(0),
                   sim_latency_s=np.zeros(0), n_pending=np.zeros(0)), "at least one"),
}


@pytest.mark.parametrize("kw,match", list(BAD_LOGS.values()), ids=list(BAD_LOGS))
def test_event_log_refuses_like_jax(kw, match):
    for cls in (EventLog, JaxEventLog):
        with pytest.raises(ValueError, match=match):
            cls(**kw)


def test_observability_refusals():
    with pytest.raises(ValueError, match="positive"):
        slo_attainment(np.ones(3), 0.0)
    with pytest.raises(ValueError, match="non-empty"):
        latency_percentiles(np.array([]))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_smoke_writes_service_json(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.service.run", "--smoke", "--device", "cpu",
         "--results-root", str(tmp_path), "--segments", "2", "--rate", "200"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    out_dir = Path(last["out_dir"])
    assert out_dir == tmp_path / "sustained_service" / "v0001"
    rec = json.loads((out_dir / "service.json").read_text())
    assert rec["kind"] == "sustained_service" and rec["schema"] == 1
    assert rec["service"]["segments"] == 2 and rec["service"]["segment_events"] == 20
    assert rec["service"]["target_rate_events_per_s"] == 200.0
    assert sorted(p.name for p in (out_dir / "figures").iterdir()) == [
        "service_latency_cdf.svg", "service_occupancy.svg", "service_steady_state.svg"]
    assert "device=cpu" in out.stdout
