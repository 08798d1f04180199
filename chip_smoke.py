"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/csrc/`, holds each
against its plain PyTorch version on the card, drives the paper simulation
(`run_simulation`) through them on all three engines, and checks its
traces against the same runs on the CPU.  Phases, in order:

  1. card identity (nvidia-smi name and power limit, torch and CUDA versions);
  2. kernel build (one nvcc per source, started together; plain C
     interfaces loaded with ctypes);
  3. K2, the polyblock projection, against its plain version, float64 and
     float32, at 2 x 131072 vertices and at the main path's shape;
  4. K1, the whole Algorithm-1 solve, against its plain version, float64
     and float32, at 32768 devices x 4 sub-channels and at the main path's
     shape;
  5. K3, the eq.-34 weighted mean, against its plain version (random,
     all-zero and single-slot weights) at the main path's shapes (the six
     mnist-MLP leaves, K = 4) and at K = 16, N = 2^25;
  6. the main paths, each driven with every launch counter set to 0 just
     before it and read just after: run_simulation(SimConfig(rounds=30))
     — mnist MLP at full width, N=20, K=4, Table-I settings, Γ through K1,
     aggregation through K3 — on engine="loop", then ra_solver="step" for
     10 rounds through K2, then engine="scan", then aggregation="async"
     and "async_full" on the async engine; traces equal to the
     device="cpu" run, losses within 1e-4 of it, and async_full bitwise
     equal to the card's scan run; then one warm run of the loop and scan
     engines under torch.profiler (the card's busy time and idle share)
     and one run of each engine under torch's sync debug mode (every host
     sync, by source line);
  7. the kernel list as one JSON line.

Any failure raises; the last line is the device JSON only when every phase
passed.  Exits non-zero without a CUDA device or without the repository's
`src/` beside this file.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA device")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import WirelessConfig, is_infeasible, total_energy  # noqa: E402
from repro_torch.core.leader_torch import host_int  # noqa: E402
from repro_torch.fl import SimConfig, run_simulation  # noqa: E402
from repro_torch.fl.sim import _prepare  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.fedavg_agg import fedavg_agg_plain, fedavg_aggregate  # noqa: E402
from repro_torch.models.small import get_small_model  # noqa: E402
from repro_torch.kernels.polyblock_fused.ops import (  # noqa: E402
    polyblock_solve_fused, polyblock_solve_plain)
from repro_torch.kernels.polyblock_project.ops import (  # noqa: E402
    polyblock_project, project_bisect)

DEV = torch.device("cuda", 0)
# Peak rates of one H100 SXM at its full 700 W (NVIDIA data sheet, dense,
# outside the tensor cores): float64 34 TFLOP/s, float32 67 TFLOP/s; HBM3
# 3.35 TB/s.
PEAK_OPS = {torch.float64: 34e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# Add-equivalent op counts of the JAX package's cost model
# (launch/analytic.py: OP_WEIGHTS prices a division at 4 and a log1p at 12;
# g_eval_ops, _f_eval_ops, projection_ops).
G_EVAL = 2 + 9 + 4 * 1 + 1 + 12 * 1          # adds, muls, div, max, log1p
F_EVAL = 2 + 4 + 4 * 2 + 2 + 12 * 1          # adds, muls, 2 divs, 2 max, log1p
BISECT_STEP = 1 + 3 + G_EVAL + 1 + 2          # mid, scaled vertex, g, cmp, 2 selects
PROJ_FIXED = (G_EVAL + 1) + (1 + 2)           # feasibility test; select + 2 muls
SELECT_FIXED = 2 + 3 + 6 + 1                  # incumbent / retirement bookkeeping
EPS = 0.01


def line(msg: str = "") -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, *, prefill: bool = False) -> float:
    """Mean time of one call, by CUDA events around `reps` calls.

    Without `prefill` the events also count any time the card waits for
    the host to enqueue the next launch.  With `prefill` the card first
    sleeps for longer than the host takes to enqueue all `reps` calls, so
    the events see the launches back to back: the device's own time.  It
    raises if the card reached the start event before the host had
    finished enqueueing (the queue was not full)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if prefill:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        # Clock cycles at no more than 2 GHz: the sleep lasts >= 3x host_s.
        torch.cuda._sleep(int(host_s * 3 * 2e9) + 1_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if prefill and start.query():
        raise AssertionError("time_ms(prefill=True): the queue ran dry; sleep longer")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ops: float, nbytes: float, dtype) -> tuple[float, str]:
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    if a.numel() == 0:
        return 0.0
    return float(((a - b).abs() / b.abs().clamp_min(1e-300)).max())


def feasible_draw(n: int, seed: int, cfg: WirelessConfig):
    """n feasible (beta, h2) pairs drawn as the JAX package's kernel tests
    draw them: h2 ~ 3 Exp(1), beta ~ U{5..59}, Prop-1 infeasible dropped."""
    rng = np.random.default_rng(seed)
    h2 = rng.exponential(size=2 * n) * 3
    beta = rng.integers(5, 60, 2 * n).astype(np.float64)
    keep = ~is_infeasible(h2, cfg, np.full(2 * n, cfg.e_max_j))
    assert keep.sum() >= n, "not enough feasible pairs drawn"
    return beta[keep][:n], h2[keep][:n]


def main_path_pairs(cfg: SimConfig):
    """The feasible (beta, h2, e_max) pairs the simulation's Γ solve hands
    the kernels: its (rounds, K, N) horizon, Prop-1 filtered, flattened."""
    prep = _prepare(cfg, torch.device("cpu"))
    shape = prep.h2_all.shape
    beta = np.broadcast_to(prep.beta[None, None, :], shape).reshape(-1)
    e_max = np.broadcast_to(prep.emax_all[:, None, :], shape).reshape(-1)
    h2 = prep.h2_all.reshape(-1)
    keep = ~is_infeasible(h2, prep.wcfg, e_max)
    return beta[keep], h2[keep], e_max[keep], prep.wcfg


# ---------------------------------------------------------------------------
# K2: the projection
# ---------------------------------------------------------------------------

def k2_ops(v, beta, h2, e_max, cfg) -> float:
    """Operations this data needs: every vertex is tested; only the ones
    outside G run their 60 halvings."""
    need = (project_need(v, beta, h2, e_max, cfg)).sum().item()
    return v.shape[0] * PROJ_FIXED + need * 60 * BISECT_STEP


def project_need(v, beta, h2, e_max, cfg):
    """Which vertices lie outside G (g > 0) and so need a root."""
    return total_energy(v[:, 0], v[:, 1], beta, h2, cfg) - e_max > 0


def check_k2(v64, beta64, h264, e64, cfg, label: str, reps: int) -> dict:
    """float64: within 1e-10 relative of the plain version (log1p's last ulp
    and torch's reciprocal-multiply division by a scalar are the only
    differences).  float32: the root is resolved only to float32 noise,
    whose tail at 2^18 vertices exceeds the JAX package's small-batch 1e-4
    contract for the plain version as well; so the kernel must be no less
    accurate than the plain float32 version against the float64 one (its
    worst error at most 2x the plain version's)."""
    out = {}
    p64 = None
    for dtype in (torch.float64, torch.float32):
        args = [x.to(dtype).contiguous() for x in (v64, beta64, h264, e64)]
        got = polyblock_project(*args, cfg)
        want = project_bisect(*args, cfg)
        torch.cuda.synchronize()
        r = rel(got, want)
        if dtype == torch.float64:
            p64 = want
            ok, verdict = r < 1e-10, f"max_rel(zeta*v)={r:.3e} (limit 1e-10)"
        else:
            e_k, e_p = rel(got, p64), rel(want, p64)
            ok = e_k <= 2 * e_p
            verdict = (f"max_rel vs plain f32={r:.3e}; vs plain f64: kernel {e_k:.3e}, "
                       f"plain f32 {e_p:.3e} (limit: kernel <= 2x plain)")
        ms = time_ms(lambda: polyblock_project(*args, cfg), reps)
        plain_ms = time_ms(lambda: project_bisect(*args, cfg), max(1, reps // 10))
        ops = k2_ops(*args, cfg)
        nbytes = v64.shape[0] * 7 * args[0].element_size()
        b_ms, b_by = bound_ms(ops, nbytes, dtype)
        max_abs = float((got - want).abs().max())
        line(f"K2 {label} {str(dtype)[6:]}: n={v64.shape[0]} {verdict} max_abs={max_abs:.3e} "
             f"kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} bound_ms={b_ms:.5f} ({b_by}) "
             f"speedup_vs_plain={plain_ms / ms:.1f}x")
        if not ok:
            raise AssertionError(f"K2 {label} {dtype}: kernel disagrees with plain")
        out[dtype] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by)
    return out


def children_of_first_iteration(beta, h2, e_max, cfg):
    """The vertices K2 projects in the step driver's first children call:
    both eq.-23 children of every feasible pair's projected (1, 1)."""
    one = torch.ones(beta.shape[0], 2, dtype=beta.dtype, device=beta.device)
    phi = project_bisect(one, beta, h2, e_max, cfg)
    c1 = torch.stack([phi[:, 0], one[:, 1]], -1)
    c2 = torch.stack([one[:, 0], phi[:, 1]], -1)
    cat = lambda x: torch.cat([x, x])
    return torch.cat([c1, c2]), cat(beta), cat(h2), cat(e_max)


# ---------------------------------------------------------------------------
# K1: the whole solve
# ---------------------------------------------------------------------------

def k1_ops(beta, h2, e_max, iters, cfg) -> float:
    """Operations this data needs, from the solve's own iteration counts:
    a pair makes 1 + 2 * iters projections and objective evaluations and
    iters + 1 selections over its written slots; its projections run their
    halvings only when its (1, 1) vertex lies outside G (the children of a
    vertex outside G lie outside G too: g increases in tau and p, eq. 22)."""
    one = torch.ones(beta.shape[0], 2, dtype=beta.dtype, device=beta.device)
    need0 = project_need(one, beta, h2, e_max, cfg).double()
    it = iters.double()
    proj = 1 + 2 * it
    ops = proj * (PROJ_FIXED + F_EVAL) + need0 * proj * 60 * BISECT_STEP
    ops = ops + (it + 1) * SELECT_FIXED + (it + 1) * (it + 2) / 2
    return float(ops.sum())


def trajectory(got, want):
    """Share of pairs on the reference's trajectory (same iteration count),
    the worst relative error of (tau, p, T) on them, and the worst |dT| on
    the rest."""
    same = got[3] == want[3]
    errs = [rel(g[same], w[same]) for g, w in zip(got[:3], want[:3])]
    rest = ~same
    dt = float((got[2][rest].double() - want[2][rest].double()).abs().max()) \
        if rest.any() else 0.0
    return float(same.double().mean()), errs, dt, int(rest.sum())


def fmt(share, errs, dt, n_rest) -> str:
    return (f"same_trajectory={share:.6f} ({n_rest} differ) "
            f"max_rel_same(tau,p,T)=({errs[0]:.2e},{errs[1]:.2e},{errs[2]:.2e}) "
            f"max_abs_dT_rest={dt:.2e}")


def check_k1(beta64, h264, e64, cfg, label: str, reps: int) -> dict:
    """float64: against the plain float64 version under the trajectory
    contract of the JAX package's float32 study (tests/test_kernels.py) —
    > 97% of pairs on its trajectory, within 1e-9 relative there, |dT| <= eps
    on the rest.  float32: > 97% of pairs on the plain float32 version's
    trajectory, and T within 1e-2 relative of the plain float64 version on
    every pair.  The float32 study's tighter terms (1e-4 on tau and p,
    |dT| <= eps off trajectory) hold on its 140-pair grid but not at 10^5
    pairs, for the plain float32 version as much as for the kernel: float32
    noise moves tau and p of flat optima by percents and re-routes a few
    slow pairs (T ~ 10^3 s) to a stop up to ~2.5e-3 away."""
    out = {}
    p64 = None
    for dtype in (torch.float64, torch.float32):
        args = [x.to(dtype).contiguous() for x in (beta64, h264, e64)]
        got = polyblock_solve_fused(*args, cfg)
        want = polyblock_solve_plain(*args, cfg)
        torch.cuda.synchronize()
        share, errs, dt, n_rest = trajectory(got, want)
        verdict = f"vs plain {str(dtype)[6:]}: " + fmt(share, errs, dt, n_rest)
        if dtype == torch.float64:
            p64 = want
            ok = share > 0.97 and max(errs) < 1e-9 and dt <= EPS + 1e-6
            verdict += " (limits: > 0.97, 1e-9, eps)"
        else:
            t_rel = rel(got[2], p64[2])
            ok = share > 0.97 and t_rel < 1e-2
            verdict += (f" (limit: > 0.97); T vs plain f64 max_rel={t_rel:.2e} (limit 1e-2); "
                        "plain f32 vs plain f64: " + fmt(*trajectory(want, p64)))
        max_abs = max(float((g.double() - w.double()).abs().max())
                      for g, w in zip(got[:3], want[:3]))
        ms = time_ms(lambda: polyblock_solve_fused(*args, cfg), reps)
        plain_ms = time_ms(lambda: polyblock_solve_plain(*args, cfg), 1)
        ops = k1_ops(*args, got[3], cfg)
        nbytes = beta64.shape[0] * (6 * args[0].element_size() + 4)
        b_ms, b_by = bound_ms(ops, nbytes, dtype)
        line(f"K1 {label} {str(dtype)[6:]}: pairs={beta64.shape[0]} {verdict} "
             f"mean_iters={float(got[3].double().mean()):.3f} max_iters={int(got[3].max())} "
             f"kernel_ms={ms:.4f} plain_ms={plain_ms:.2f} bound_ms={b_ms:.5f} ({b_by}) "
             f"speedup_vs_plain={plain_ms / ms:.1f}x")
        if not ok:
            raise AssertionError(f"K1 {label} {dtype}: kernel disagrees with plain")
        out[dtype] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by)
    return out


# ---------------------------------------------------------------------------
# K3: the eq.-34 weighted mean
# ---------------------------------------------------------------------------

def k3_weight_cases(k: int, gen) -> list[tuple[str, torch.Tensor]]:
    one = torch.zeros(k, device=DEV)
    one[k // 2] = 7.0
    return [("random", torch.rand(k, generator=gen, device=DEV) * 50 + 1),
            ("all_zero", torch.zeros(k, device=DEV)), ("one_slot", one)]


def check_k3(xs: list[torch.Tensor], label: str, reps: int, plain_reps: int) -> dict:
    """The kernel against its plain version on each (K, N) tensor of `xs`
    (one call per tensor, as the server calls it once per leaf), for random,
    all-zero and single-slot weights.  Both make the same float32
    operations in the same order, so they must agree to 1e-6 relative (and
    in practice to the bit); all-zero weights must give exactly 0 and a
    single non-zero slot exactly that slot.  Times are for the whole list:
    one aggregation's launches: `ms`, `plain_ms` and `library_ms` are the
    card's own time (queue prefilled, see `time_ms`), `host_ms` the
    kernel's time as a caller sees it, host enqueue included.  A prefilled
    timing keeps its launches (reps x launches per call) below ~1000, the
    depth of the card's launch queue: past it the host blocks, and the
    card catches up before the host has enqueued everything."""
    gen = torch.Generator(DEV).manual_seed(len(xs))
    k = xs[0].shape[0]
    max_abs, bitwise = 0.0, True
    for case, w in k3_weight_cases(k, gen):
        for x in xs:
            got = fedavg_aggregate(x, w)
            want = fedavg_agg_plain(x, w)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_abs = max(max_abs, err)
            bitwise &= bool(torch.equal(got, want))
            if not torch.allclose(got, want, rtol=1e-6, atol=1e-6):
                raise AssertionError(f"K3 {label} {case}: kernel disagrees with plain "
                                     f"(max_abs {err:.3e})")
            if case == "all_zero" and bool(got.any()):
                raise AssertionError(f"K3 {label}: all-zero weights did not give 0")
            if case == "one_slot" and not torch.equal(got, x[k // 2]):
                raise AssertionError(f"K3 {label}: one slot did not give that slot")
    w = k3_weight_cases(k, gen)[0][1]
    w_hat = w / w.sum()
    host_ms = time_ms(lambda: [fedavg_aggregate(x, w) for x in xs], reps)
    ms = time_ms(lambda: [fedavg_aggregate(x, w) for x in xs], reps, prefill=True)
    plain_ms = time_ms(lambda: [fedavg_agg_plain(x, w) for x in xs], plain_reps,
                       prefill=True)
    library_ms = time_ms(lambda: [torch.matmul(w_hat, x) for x in xs], reps, prefill=True)
    n_total = sum(x.shape[1] for x in xs)
    b_ms, b_by = bound_ms(2 * k * n_total, (k + 1) * n_total * 4, torch.float32)
    line(f"K3 {label}: K={k} N={'+'.join(str(x.shape[1]) for x in xs)} launches={len(xs)} "
         f"max_abs_err={max_abs:.3e} bitwise_equal_plain={bitwise} kernel_ms={ms:.4f} "
         f"kernel_ms_with_host_enqueue={host_ms:.4f} "
         f"plain_ms={plain_ms:.4f} library_ms(matmul)={library_ms:.4f} "
         f"bound_ms={b_ms:.5f} ({b_by}) achieved_GB/s={(k + 1) * n_total * 4 / ms / 1e6:.1f}")
    if len(xs) > 1:
        for x in xs:
            leaf_ms = time_ms(lambda: fedavg_aggregate(x, w), reps, prefill=True)
            line(f"  leaf N={x.shape[1]}: kernel_ms={leaf_ms:.4f}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


# ---------------------------------------------------------------------------
# the main paths
# ---------------------------------------------------------------------------

COUNTERS = {"polyblock_fused": polyblock_solve_fused,
            "polyblock_project": polyblock_project,
            "fedavg_agg": fedavg_aggregate}


def run_on_card(cfg: SimConfig, **kw):
    """One run on the card with every launch counter (and the host-read
    counter) set to 0 just before it; returns the history, wall seconds,
    the launch counts and the host reads of that run."""
    for fn in COUNTERS.values():
        fn.launches = 0
    host_int.syncs = 0
    t0 = time.perf_counter()
    hist = run_simulation(cfg, device=DEV, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return hist, wall, {name: fn.launches for name, fn in COUNTERS.items()}, host_int.syncs


def max_rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300), initial=0.0))


def drive(cfg: SimConfig, need: tuple[str, ...], **kw) -> tuple:
    """Drive one main path on the card twice and once on the CPU; check the
    card's run against the CPU's and that each kernel in `need` launched."""
    hist, wall, launches, syncs = run_on_card(cfg, **kw)
    again, warm_wall, _, _ = run_on_card(cfg, **kw)
    t0 = time.perf_counter()
    ref = run_simulation(cfg, device="cpu", **kw)
    cpu_wall = time.perf_counter() - t0
    name = " ".join(f"{k}={v}" for k, v in kw.items()) or "engine=loop"
    line(f"main path {name} aggregation={cfg.aggregation} rounds={cfg.rounds}: launches "
         + " ".join(f"{k}={v}" for k, v in launches.items())
         + f"; host reads={syncs} ({syncs / cfg.rounds:.2f} per round); gpu wall_s first "
         f"run={wall:.3f} (plan_wall_s={hist.plan_wall_s:.4f}), second run={warm_wall:.3f} "
         f"(plan_wall_s={again.plan_wall_s:.4f}); cpu wall_s={cpu_wall:.3f} "
         f"(plan_wall_s={ref.plan_wall_s:.4f})")
    line("  loss: " + " ".join(f"{x:.4f}" for x in hist.global_loss))
    line("  acc:  " + " ".join(f"{x:.3f}" for x in hist.accuracy))
    same = {f: np.array_equal(getattr(hist, f), getattr(ref, f))
            for f in ("tx_trace", "age_trace", "commit_trace")
            if getattr(ref, f) is not None}
    lat_rel = max_rel(hist.latency_all, ref.latency_all)
    loss_rel = max_rel(hist.global_loss, ref.global_loss)
    line("  " + "; ".join(f"{f} == cpu: {v}" for f, v in same.items())
         + f"; latency max_rel vs cpu: {lat_rel:.3e} (limit 1e-6); loss max_rel vs cpu: "
         f"{loss_rel:.3e} (limit 1e-4); transmissions: {int(hist.tx_trace.sum())}")
    for kernel in need:
        if launches[kernel] < 1:
            raise AssertionError(f"{kernel} was not launched on the main path {name}")
    if not (np.all(np.isfinite(hist.global_loss)) and hist.global_loss.shape == (cfg.rounds,)):
        raise AssertionError("losses are not finite / not one per round")
    if not hist.global_loss[-1] < hist.global_loss[0]:
        raise AssertionError("training did not lower the loss")
    if not np.array_equal(again.tx_trace, hist.tx_trace):
        raise AssertionError("two runs of the same seed on the card differ in tx")
    if not all(same.values()):
        raise AssertionError("traces differ from the CPU run")
    if not (lat_rel <= 1e-6 and loss_rel <= 1e-4):
        raise AssertionError("latency or loss too far from the CPU run")
    return hist, launches


def profile_run(cfg: SimConfig, **kw) -> None:
    """Where a warm run's time goes: one run under torch.profiler (after an
    unprofiled warm-up run): wall time, the card's busy time (the sum of
    its kernels' self time; one stream, so kernels do not overlap), its
    idle share, the kernel count, and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile
    run_simulation(cfg, device=DEV, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_simulation(cfg, device=DEV, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    name = " ".join(f"{k}={v}" for k, v in kw.items()) or "engine=loop"
    if busy_ms == 0:
        line(f"profile {name}: wall_s={wall:.3f}; device time not measured (no device events)")
        return
    line(f"profile {name} rounds={cfg.rounds}: wall_s={wall:.3f} (profiled) device_busy_ms="
         f"{busy_ms:.2f} device_idle_share={1 - busy_ms / 1e3 / wall:.4f} "
         f"kernel_launches={sum(e.count for e in kernels)}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        line(f"  {e.self_device_time_total / 1e3:8.3f} ms  {e.count:6d}x  {e.key[:90]}")


def count_syncs(cfg: SimConfig, **kw) -> None:
    """Every host sync of one run, as torch's sync debug mode reports them
    (one warning per synchronizing call), by the source line that made it,
    beside the engine's own count of its host reads (`host_int`)."""
    host_int.syncs = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run_simulation(cfg, device=DEV, **kw)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    by_line = collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in syncs)
    name = " ".join(f"{k}={v}" for k, v in kw.items()) or "engine=loop"
    line(f"syncs {name} rounds={cfg.rounds}: {len(syncs)} synchronizing calls "
         f"({len(syncs) / cfg.rounds:.2f} per round); host_int reads={host_int.syncs}; "
         "by source line: " + ", ".join(f"{k} x{v}" for k, v in by_line.most_common(8)))


def assert_bitwise(a, b, what: str) -> None:
    """Every per-round field of two histories equal to the bit."""
    diff = []
    for f in dataclasses.fields(a):
        if f.name in ("wall_s", "plan_wall_s", "commit_trace", "async_trace"):
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if not (np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y):
            diff.append(f.name)
    line(f"{what}: bitwise equal in every field: {not diff}" + (f" (differ: {diff})" if diff else ""))
    if diff:
        raise AssertionError(f"{what}: fields differ: {diff}")


def main() -> None:
    t_all = time.perf_counter()
    # ---- 1. card identity -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    line(smi.splitlines()[0])            # the card's name and power limit
    line(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
         f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line("tf32: torch.backends.cuda.matmul.allow_tf32=False, "
         "torch.backends.cudnn.allow_tf32=False")

    # ---- 2. kernel build --------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(_build.load_polyblock), pool.submit(_build.load_fedavg)]:
            fut.result()
    line(f"build: both libraries loaded in {time.perf_counter() - t0:.2f}s; "
         f"flags: {' '.join(_build.NVCC_FLAGS)}")
    for lib in ("polyblock", "fedavg_agg"):
        info = _build.build_info(lib)
        line(f"  {lib}: {info['library']} nvcc_s={info['seconds']:.2f}")
        for ln in info["log"].splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                line("  ptxas: " + ln.strip())

    cfg_w = WirelessConfig()
    to = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64, device=DEV)

    # ---- 3. K2 --------------------------------------------------------------
    n2 = 131072
    beta, h2 = feasible_draw(n2, seed=11, cfg=cfg_w)
    rng = np.random.default_rng(12)
    v = rng.uniform(0.05, 1, (2 * n2, 2))
    beta2, h22 = np.concatenate([beta, beta]), np.concatenate([h2, h2])
    check_k2(to(v), to(beta2), to(h22), to(np.full(2 * n2, cfg_w.e_max_j)), cfg_w,
             "2x131072 vertices", reps=20)
    step_cfg = SimConfig(rounds=10)
    mb, mh, me, mcfg = main_path_pairs(step_cfg)
    k2_main = check_k2(*children_of_first_iteration(to(mb), to(mh), to(me), mcfg), mcfg,
                       "main-path shape (first children call, rounds=10)", reps=50)

    # ---- 4. K1 --------------------------------------------------------------
    n_dev, k_sub = 32768, 4
    rng = np.random.default_rng(21)
    h2_mat = rng.exponential(size=(k_sub, n_dev)) * 3
    beta_mat = np.broadcast_to(rng.integers(5, 60, n_dev).astype(np.float64), h2_mat.shape)
    keep = ~is_infeasible(h2_mat, cfg_w, np.full(h2_mat.shape, cfg_w.e_max_j))
    line(f"K1 batch: {n_dev} devices x {k_sub} sub-channels, "
         f"{int(keep.sum())} Prop-1 feasible pairs")
    check_k1(to(beta_mat[keep]), to(h2_mat[keep]),
             to(np.full(int(keep.sum()), cfg_w.e_max_j)), cfg_w,
             f"{n_dev}x{k_sub}", reps=10)
    main_cfg = SimConfig(rounds=30)
    mb, mh, me, mcfg = main_path_pairs(main_cfg)
    k1_main = check_k1(to(mb), to(mh), to(me), mcfg, "main-path shape (rounds=30)",
                       reps=50)

    # ---- 5. K3 ---------------------------------------------------------------
    gen = torch.Generator(DEV).manual_seed(5)
    leaves = [torch.randn((4,) + p.shape, generator=gen, device=DEV).reshape(4, -1)
              for p in get_small_model(main_cfg.dataset).parameters()]
    k3_main = check_k3(leaves, "main-path shape (mnist MLP leaves, one aggregation)",
                       reps=50, plain_reps=3)
    big = torch.randn(16, 1 << 25, generator=gen, device=DEV)
    check_k3([big], "K=16 N=2^25", reps=20, plain_reps=2)
    del big

    # ---- 6. the main paths ----------------------------------------------------
    _, loop_launches = drive(main_cfg, ("polyblock_fused", "fedavg_agg"))
    _, step_launches = drive(step_cfg, ("polyblock_project", "fedavg_agg"), ra_solver="step")
    scan, scan_launches = drive(main_cfg, ("polyblock_fused", "fedavg_agg"), engine="scan")
    _, async_launches = drive(dataclasses.replace(main_cfg, aggregation="async"),
                              ("polyblock_fused", "fedavg_agg"), engine="async")
    full, _, _, _ = run_on_card(dataclasses.replace(main_cfg, aggregation="async_full"),
                                engine="async")
    assert_bitwise(full, scan, "async_full vs scan on the card")
    profile_run(main_cfg)
    profile_run(main_cfg, engine="scan")
    count_syncs(main_cfg)
    count_syncs(main_cfg, engine="scan")
    count_syncs(dataclasses.replace(main_cfg, aggregation="async"), engine="async")
    line("K3 launches per run_simulation: "
         + " ".join(f"{name}={c['fedavg_agg']}" for name, c in (
             ("loop", loop_launches), ("loop_step", step_launches),
             ("scan", scan_launches), ("async", async_launches))))

    # ---- 7. kernel list -----------------------------------------------------
    kernels = []
    for name, src, replaces, launches, res in (
            ("polyblock_fused", "src/repro_torch/csrc/polyblock.cu",
             "src/repro/kernels/polyblock_fused/kernel.py:61",
             loop_launches["polyblock_fused"], dict(k1_main[torch.float64], library_ms=None)),
            ("polyblock_project", "src/repro_torch/csrc/polyblock.cu",
             "src/repro/kernels/polyblock_project/kernel.py:39",
             step_launches["polyblock_project"], dict(k2_main[torch.float64], library_ms=None)),
            ("fedavg_agg", "src/repro_torch/csrc/fedavg_agg.cu",
             "src/repro/kernels/fedavg_agg/kernel.py:22",
             scan_launches["fedavg_agg"], k3_main)):
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=launches, max_abs_err=res["max_abs_err"],
                            ms=res["ms"], plain_ms=res["plain_ms"],
                            bound_ms=res["bound_ms"], bound_by=res["bound_by"],
                            library_ms=res["library_ms"]))
    line(f"total wall_s={time.perf_counter() - t_all:.1f}")
    line(json.dumps({"kernels": kernels}))
    line(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
