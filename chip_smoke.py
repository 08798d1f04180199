"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/csrc/`, holds each
against its plain PyTorch version on the card, drives the paper simulation
(`run_simulation`) and its multi-cell hierarchy (`run_hierarchical`,
`run_hier_many`) through K1-K3 on all three engines and checks their traces
against the same runs on the CPU, runs the sweep harness (`run_sweep`) and
the sustained service (`SustainedService`) on them, and serves two 7B models of the model zoo
(`serve_loop`) at full width and depth through K4 and K5.  Phases, in order:

  1. card identity (nvidia-smi name and power limit, torch and CUDA versions);
  2. kernel build (one nvcc per source, all four started together; plain C
     interfaces loaded with ctypes);
  3. K2, the polyblock projection, against its plain version, float64 and
     float32, at 2 x 131072 vertices and at the main path's shape; at both,
     the one-thread-per-vertex schedule and the cooperative one at 4, 8 and
     16 lanes per vertex timed side by side and held bitwise equal, with
     each one's critical path, and K2's bound priced from its SASS;
  4. K1, the whole Algorithm-1 solve, against its plain version, float64
     and float32, at 32768 devices x 4 sub-channels and at the main path's
     shape; at both, the one-thread-per-pair schedule and the cooperative
     one at 4, 8 and 16 lanes per child timed side by side and held
     bitwise equal, with each one's critical path (the longest pair's
     dependent evaluations of g at the measured latency per evaluation);
     then K2's lanes swept over 1 024 to ~2.3 x 10^5 of those pairs'
     first children (the sizes its lanes rule is set from);
  5. K3, the eq.-34 weighted mean, against its plain version (random,
     all-zero and single-slot weights, bitwise) at the main path's shapes
     (the six mnist-MLP leaves, K = 4, one grouped launch, timed on the card
     and as called beside the same leaves one launch each) and at K = 16,
     N = 2^25;
  6. K4, flash attention, against its plain version at qwen2-7b's prefill
     shape (B 4, S 512, Hq 28, Hkv 4, D 128, causal) in bf16 and f32 and at
     a right-aligned, windowed shape (Sq < Sk); K5, the WKV6 recurrence, at
     rwkv6-7b's prefill shape (4 x 512 x 64 heads x 64) and its T = 1
     decode shape; each with its time on the card, as called, its bound,
     the plain version's time and the library call's (SDPA for K4); the
     bf16 K4 entry's tensor-core instructions (SASS), shared memory and
     registers, and K5's threads per block, shared memory and registers;
  7. the simulation's main paths, each driven with every launch counter
     set to 0 just before it and read just after:
     run_simulation(SimConfig(rounds=30)) — mnist MLP at full width, N=20,
     K=4, Table-I settings, Γ through K1, aggregation through K3 — on
     engine="loop", then ra_solver="step" for 10 rounds through K2, then
     engine="scan", then aggregation="async" and "async_full" on the async
     engine; traces equal to the device="cpu" run, losses within 1e-4 of
     it, async_full bitwise equal to the card's scan run, and K2 launched
     exactly 9 times on the step run; then one warm run of the loop, step
     and scan paths under torch.profiler (the card's busy time and idle
     share; K2's summed device time on the step run) and one run of each
     engine under torch's sync debug mode (every host sync, by source line);
  8. the hierarchy's main paths, each driven with every launch counter set
     to 0 just before it and read just after: HierSimConfig(rounds=30) —
     mnist MLP at full width, 2 cells x 10 devices x 4 sub-channels, 400
     samples, Γ for all cells in one K1 launch, aggregation through K3 at
     both tiers — on engine="loop", "scan" and the two-tier async engine
     (aggregation="async" at both tiers), async_full at both tiers held
     bitwise equal to the card's scan run, 10 rounds with
     ra_solver="step" through K2, and a 3-cell corr_fading world with
     cell_coupling=0.5 on scan; traces equal to the device="cpu" run,
     losses within 1e-4 of it, K1 exactly once per fused run, K2 as often
     as the step driver iterates, K3 exactly as often as the traces imply
     (`hier_k3_expected`); then one warm scan run under torch.profiler and
     one under torch's sync debug mode;
  9. the sweep harness and the sustained service, each driven with every
     launch counter set to 0 just before it and read just after:
     run_sweep at `examples/torch_reproduce_figures.py`'s default widths
     and 30 rounds (mnist MLP at full width, N 20, K 4, 500 samples, the
     four paper DS policies x seeds 0 / 1 as that example's default,
     crossed with aggregation sync / async x cell counts 1 / 2: 32 cells,
     record and gallery into a temporary directory), K1 and K3 launched
     as often as the spec and the traces imply, one
     cell per (aggregation, cell count) bitwise equal to its solo run on
     the card and its traces equal to the CPU's; then SustainedService at
     `python -m repro_torch.service.run --ra mo`'s defaults (N 64, K 16,
     128 samples, batch 16, churn; one warm-up and 4 measured segments of
     100 events, closed loop): events/s, p50/p95/p99 commit latency, SLO
     attainment, K1 once per segment, K3 once per event, host reads per
     event, and one more segment under torch.profiler (K1's device ms and
     the idle share); on fresh services 2 chained segments of 50 events
     bitwise equal to one of 100 and that segment equal to the CPU's
     (traces exact, latency within 1e-6, loss within 1e-4), one segment
     with ra_solver="step" (K2) dispatching as the fused one, and one
     open-loop segment at half the closed loop's events/s; K1 against its
     plain version, its bound and critical path at the hierarchy's and
     the service's pairs;
     every number beside the card's name and power limit;
 10. the serving paths: serve_loop at full width and depth (random weights
     from a seed) for qwen2-7b with attn_impl="pallas" and for rwkv6-7b
     with rwkv_wkv_impl="pallas", batch 4, prompt 512, 32 new tokens, the
     launch counters set to 0 just before each and read just after (K4
     exactly 28, K5 exactly 1 088); prefill logits within 4e-2 of the
     "ref" path on the same weights on the card, tokens in range, logits
     finite; a second, warm run under torch's sync debug mode (no host
     sync inside the decode loop) and a third under torch.profiler;
 11. the kernel list as one JSON line (with K1-K3's launches on the
     hierarchy's, the sweep's and the service's paths: `hier_launches`,
     `sweep_launches`, `service_launches`; K1's bound at the hierarchy's
     and a service segment's pairs, `at`).

Any failure raises; the last line is the device JSON only when every phase
passed.  Exits non-zero without a CUDA device or without the repository's
`src/` beside this file.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import json
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA device")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (PAPER_BASELINE_DS, RoundPolicy,  # noqa: E402
                              WirelessConfig, is_infeasible, total_energy)
from repro_torch.core.leader_torch import host_int  # noqa: E402
from repro_torch.fl import (HierSimConfig, SimConfig, run_hier_many,  # noqa: E402
                            run_hierarchical, run_simulation)
from repro_torch.experiments import SweepSpec, run_sweep  # noqa: E402
from repro_torch.fl import hierarchical as hier  # noqa: E402
from repro_torch.fl import sim as sim_mod  # noqa: E402
from repro_torch.fl.sim import _prepare  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.data.pipeline import synthetic_token_batch  # noqa: E402
from repro_torch.kernels.fedavg_agg import (  # noqa: E402
    fedavg_agg_plain, fedavg_aggregate, fedavg_aggregate_leaves)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.rwkv6_wkv import wkv6, wkv6_plain  # noqa: E402
from repro_torch.launch.serve import serve_loop  # noqa: E402
from repro_torch.models.transformer import forward, init_params  # noqa: E402
from repro_torch.models.small import get_small_model  # noqa: E402
from repro_torch.scenarios import ScenarioStream  # noqa: E402
from repro_torch.service import ServiceConfig, SustainedService  # noqa: E402
from repro_torch.kernels.polyblock_fused.ops import (  # noqa: E402
    LANES, coop_lanes, polyblock_solve_fused, polyblock_solve_plain)
from repro_torch.kernels.polyblock_project.ops import (  # noqa: E402
    polyblock_project, project_bisect, project_lanes)

DEV = torch.device("cuda", 0)
# Peak rates of one H100 SXM at its full 700 W (NVIDIA data sheet, dense):
# float64 34 TFLOP/s and float32 67 TFLOP/s outside the tensor cores, bf16
# 989 TFLOP/s on them; HBM3 3.35 TB/s.
PEAK_OPS = {torch.float64: 34e12, torch.float32: 67e12, torch.bfloat16: 989e12}
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
# K2 launches of the 10-round ra_solver="step" run: the first projection of
# (1, 1) and one children call per iteration of its slowest pair.
K2_STEP_LAUNCHES = 9
# The card's name and power limit (nvidia-smi), set by main() and printed
# beside the numbers of the sweep-and-service phase.
CARD = ""


def line(msg: str = "") -> None:
    print(msg, flush=True)


def phase_mark(n: int, t_all: float) -> None:
    line(f"phase {n} starts at {time.perf_counter() - t_all:.1f}s")


def time_ms(fn, reps: int, *, prefill: bool = False) -> float:
    """Mean time of one call, by CUDA events around `reps` calls.

    Without `prefill` the events also count any time the card waits for
    the host to enqueue the next launch.  With `prefill` the card first
    sleeps for longer than the host takes to enqueue all `reps` calls, so
    the events see the launches back to back: the device's own time.  It
    raises if the card reached the start event before the host had
    finished enqueueing (the queue was not full).  The sleep lasts at least
    ~20 ms, and garbage is collected first, so that a pause of the host
    (a collection after a profiled run) cannot drain the queue."""
    gc.collect()
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
        torch.cuda._sleep(int(host_s * 3 * 2e9) + 40_000_000)
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


def feasible_pairs(beta, h2, e_max, cfg: WirelessConfig):
    """The Prop-1 feasible (beta, h2, e_max) of a (..., K, N) block of
    pairs, flattened; beta and e_max broadcast against h2."""
    beta = np.broadcast_to(beta, h2.shape).reshape(-1)
    e_max = np.broadcast_to(e_max, h2.shape).reshape(-1)
    h2 = h2.reshape(-1)
    keep = ~is_infeasible(h2, cfg, e_max)
    return beta[keep], h2[keep], e_max[keep]


def main_path_pairs(cfg: SimConfig):
    """The feasible (beta, h2, e_max) pairs the simulation's Γ solve hands
    the kernels: its (rounds, K, N) horizon, Prop-1 filtered, flattened."""
    prep = _prepare(cfg, torch.device("cpu"))
    return (*feasible_pairs(prep.beta[None, None, :], prep.h2_all,
                            prep.emax_all[:, None, :], prep.wcfg), prep.wcfg)


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


def k2_chain(v, beta, h2, e_max, cfg, lanes: int, n_bisect: int = 60) -> int:
    """Dependent evaluations of g on the longest vertex's chain: the vertex
    test, then, outside G, n_bisect halvings one after the other on one
    lane, or ceil(n_bisect / d) speculative rounds on L = 2^d lanes (an
    upper bound: a settled bracket evaluates no more)."""
    if not bool(project_need(v, beta, h2, e_max, cfg).any()):
        return 1
    return 1 + (n_bisect if lanes == 1 else -(-n_bisect // (lanes.bit_length() - 1)))


def k2_schedules(args, cfg, label: str, reps: int) -> dict[int, float]:
    """Every schedule (LANES) held to the one-lane schedule's bits, then
    timed (CUDA events, queue prefilled): {lanes: ms}."""
    one_lane = polyblock_project(*args, cfg, lanes=1)
    times = {}
    for lanes in LANES:
        res = polyblock_project(*args, cfg, lanes=lanes)
        torch.cuda.synchronize()
        if not torch.equal(res, one_lane):
            raise AssertionError(f"K2 {label}: lanes={lanes} differs from the one-lane "
                                 "schedule")
        times[lanes] = time_ms(lambda: polyblock_project(*args, cfg, lanes=lanes), reps,
                               prefill=True)
    return times


def check_k2(v64, beta64, h264, e64, cfg, label: str, reps: int) -> dict:
    """float64: within 1e-10 relative of the plain version (log1p's last ulp
    and torch's reciprocal-multiply division by a scalar are the only
    differences).  float32: the root is resolved only to float32 noise,
    whose tail at 2^18 vertices exceeds the JAX package's small-batch 1e-4
    contract for the plain version as well; so the kernel must be no less
    accurate than the plain float32 version against the float64 one (its
    worst error at most 2x the plain version's).

    Then every schedule (LANES: one thread per vertex, 4, 8 and 16 lanes
    per vertex) must give the one-lane schedule's bits, and each is timed
    in this run (CUDA events, queue prefilled) beside its critical path:
    its `k2_chain` at the latency per evaluation the one-lane time implies.
    The wrapper's own choice (`project_lanes`) is also timed as called,
    host enqueue included."""
    out = {}
    p64 = None
    n = v64.shape[0]
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
        sched = {lanes: (ms_l, k2_chain(*args, cfg, lanes))
                 for lanes, ms_l in k2_schedules(args, cfg, f"{label} {dtype}", reps).items()}
        per_call_ns = sched[1][0] / sched[1][1] * 1e6
        chosen = project_lanes(n)
        ms = sched[chosen][0]
        host_ms = time_ms(lambda: polyblock_project(*args, cfg), reps)
        plain_ms = time_ms(lambda: project_bisect(*args, cfg), max(1, reps // 10))
        ops = k2_ops(*args, cfg)
        nbytes = n * 7 * args[0].element_size()
        b_ms, b_by = bound_ms(ops, nbytes, dtype)
        max_abs = float((got - want).abs().max())
        line(f"K2 {label} {str(dtype)[6:]}: n={n} {verdict} max_abs={max_abs:.3e} "
             f"lanes={chosen} kernel_ms={ms:.4f} kernel_ms_with_host_enqueue={host_ms:.4f} "
             f"plain_ms={plain_ms:.3f} bound_ms={b_ms:.5f} ({b_by}) "
             f"critical_path_ms={sched[chosen][1] * per_call_ns * 1e-6:.4f} "
             f"speedup_vs_plain={plain_ms / ms:.1f}x")
        line(f"  schedules, bitwise equal to lanes=1: True; latency per evaluation of g "
             f"(lanes=1 ms / its chain) {per_call_ns:.1f} ns; "
             + "; ".join(f"lanes={k}: kernel_ms={v[0]:.4f} chain={v[1]} "
                         f"critical_path_ms={v[1] * per_call_ns * 1e-6:.4f}"
                         for k, v in sched.items()))
        if not ok:
            raise AssertionError(f"K2 {label} {dtype}: kernel disagrees with plain")
        # Evaluations of g this data needs: every vertex's test, and 60
        # halvings for each vertex outside G.
        evals = n + int(project_need(*args, cfg).sum()) * 60
        out[dtype] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, lanes=chosen, evals=evals)
    return out


def sweep_k2(v64, beta64, h264, e64, cfg, label: str, sizes, reps: int) -> None:
    """Where wide speculation stops paying: every schedule timed (queue
    prefilled) on the first n vertices for each n in `sizes`, float64 and
    float32, each held bitwise to the one-lane schedule; the sizes the
    rule `project_lanes` is set from."""
    for dtype in (torch.float64, torch.float32):
        for n in sizes:
            args = [x[:n].to(dtype).contiguous() for x in (v64, beta64, h264, e64)]
            times = k2_schedules(args, cfg, f"sweep {label} n={n} {dtype}", reps)
            best = min(times, key=times.get)
            line(f"K2 sweep {label} {str(dtype)[6:]} n={n}: bitwise equal to lanes=1: True; "
                 + " ".join(f"lanes={k}: {v:.4f}" for k, v in times.items())
                 + f" ms; fastest lanes={best}; rule project_lanes={project_lanes(n)}")


def k2_sass_bound(evals: int) -> None:
    """K2's bound priced from the card's instruction count instead of the
    JAX cost model's add-equivalents: the FP64-pipe instructions (DADD,
    DMUL, DFMA, DSETP, DMNMX) in the SASS of the one-lane
    `project_kernel<double>`, over its two inlined evaluations of g (the
    vertex test and the loop body: the two call sites of energy() in
    project()), at the card's FP64 issue rate (one instruction per FP64
    lane per clock: PEAK_OPS / 2, an FMA being two operations).  A static
    count, so an upper estimate: both sides of log1p's branches and the
    divisions' slow paths are in it."""
    ops = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "MUFU")
    counts = _build.sass_opcodes("polyblock", ops)
    for fn, c in counts.items():
        if "project" in fn:
            line(f"K2 SASS, {fn}: " + " ".join(f"{op}={k}" for op, k in c.items()))
    one = [c for fn, c in counts.items() if "project_kernelIdE" in fn]
    if not one:
        raise AssertionError("K2 SASS: project_kernel<double> not found")
    per_eval = sum(one[0][op] for op in ops[:-1]) / 2
    b_ms = evals * per_eval / (PEAK_OPS[torch.float64] / 2) * 1e3
    line(f"K2 SASS bound (main path f64): {per_eval:.1f} FP64-pipe instructions per "
         f"evaluation of g (project_kernel<double>, 2 inlined); {evals} evaluations this "
         f"data needs -> bound_ms={b_ms:.6f} at {PEAK_OPS[torch.float64] / 2:.3g} FP64 "
         "instructions/s")


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


def chain_calls(beta, h2, e_max, iters, cfg, lanes: int, n_bisect: int = 60) -> int:
    """Dependent evaluations of g on the longest pair's serial chain: one
    lane per pair runs 1 + 2 * iters projections one after the other,
    2L lanes run the two children of an iteration at once (1 + iters deep)
    and 60 halvings in ceil(60 / d) speculative rounds (L = 2^d); each
    projection first tests its vertex, and halves only outside G.  The
    cooperative count is an upper bound: its rounds evaluate nothing once
    the bracket settles at float precision (~24 halvings in float32, ~53 in
    float64)."""
    one = torch.ones(beta.shape[0], 2, dtype=beta.dtype, device=beta.device)
    need0 = project_need(one, beta, h2, e_max, cfg).long()
    it = iters.long()
    if lanes == 1:
        calls = (1 + 2 * it) * (1 + need0 * n_bisect)
    else:
        d = lanes.bit_length() - 1
        calls = (1 + it) * (1 + need0 * -(-n_bisect // d))
    return int(calls.max())


def check_k1(beta64, h264, e64, cfg, label: str, reps: int, bulk_iters: int = 0) -> dict:
    """float64: against the plain float64 version under the trajectory
    contract of the JAX package's float32 study (tests/test_kernels.py) —
    > 97% of pairs on its trajectory, within 1e-9 relative there, |dT| <= eps
    on the rest.  float32: > 97% of pairs on the plain float32 version's
    trajectory, and T within 1e-2 relative of the plain float64 version on
    every pair.  The float32 study's tighter terms (1e-4 on tau and p,
    |dT| <= eps off trajectory) hold on its 140-pair grid but not at 10^5
    pairs, for the plain float32 version as much as for the kernel: float32
    noise moves tau and p of flat optima by percents and re-routes a few
    slow pairs (T ~ 10^3 s) to a stop up to ~2.5e-3 away.

    Then every schedule (LANES: one thread per pair, 4, 8 and 16 lanes per
    child) must give the one-lane schedule's bits, and each is timed in
    this run (CUDA events, queue prefilled) beside its critical path: its
    `chain_calls` at the latency per evaluation the one-lane time implies.
    With `bulk_iters`, the chosen and the one-lane schedules are timed once
    more with every pair cut at that many iterations: the batch's bulk
    without its few long pairs' chains."""
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
        one_lane = polyblock_solve_fused(*args, cfg, lanes=1)
        sched = {}
        for lanes in LANES:
            res = polyblock_solve_fused(*args, cfg, lanes=lanes)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(a, b) for a, b in zip(res, one_lane))
            if not bitwise:
                raise AssertionError(f"K1 {label} {dtype}: lanes={lanes} differs from "
                                     "the one-lane schedule")
            ms_l = time_ms(lambda: polyblock_solve_fused(*args, cfg, lanes=lanes), reps,
                           prefill=True)
            sched[lanes] = (ms_l, chain_calls(*args, got[3], cfg, lanes))
        per_call_ns = sched[1][0] / sched[1][1] * 1e6
        chosen = coop_lanes(beta64.shape[0])
        ms = sched[chosen][0]
        plain_ms = time_ms(lambda: polyblock_solve_plain(*args, cfg), 1)
        ops = k1_ops(*args, got[3], cfg)
        nbytes = beta64.shape[0] * (6 * args[0].element_size() + 4)
        b_ms, b_by = bound_ms(ops, nbytes, dtype)
        crit_ms = sched[chosen][1] * per_call_ns * 1e-6
        line(f"K1 {label} {str(dtype)[6:]}: pairs={beta64.shape[0]} {verdict} "
             f"mean_iters={float(got[3].double().mean()):.3f} max_iters={int(got[3].max())} "
             f"lanes={chosen} kernel_ms={ms:.4f} plain_ms={plain_ms:.2f} "
             f"bound_ms={b_ms:.5f} ({b_by}) critical_path_ms={crit_ms:.4f} "
             f"speedup_vs_plain={plain_ms / ms:.1f}x")
        line(f"  schedules, bitwise equal to lanes=1: True; latency per evaluation of g "
             f"(lanes=1 ms / its chain) {per_call_ns:.1f} ns; "
             + "; ".join(f"lanes={k}: kernel_ms={v[0]:.4f} chain={v[1]} "
                         f"critical_path_ms={v[1] * per_call_ns * 1e-6:.4f}"
                         for k, v in sched.items()))
        if bulk_iters:
            cut = []
            for lanes in (chosen, 1):
                cut_ms = time_ms(lambda: polyblock_solve_fused(
                    *args, cfg, max_iter=bulk_iters, lanes=lanes), reps, prefill=True)
                cut.append(f"lanes={lanes}: kernel_ms={cut_ms:.4f}")
            line(f"  bulk alone, every pair cut at max_iter={bulk_iters}: " + "; ".join(cut))
        if not ok:
            raise AssertionError(f"K1 {label} {dtype}: kernel disagrees with plain")
        out[dtype] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, lanes=chosen)
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
    """The kernel against its plain version on the (K, n_i) leaves `xs` of
    one aggregation (one grouped call, as the server makes it), for random,
    all-zero and single-slot weights.  Both make the same float32
    operations in the same order, so they must agree to the bit; all-zero
    weights must give exactly 0 and a single non-zero slot exactly that
    slot.  Times are for the whole aggregation: `ms`, `plain_ms` and
    `library_ms` (`torch.matmul` per leaf) are the card's own time (queue
    prefilled, see `time_ms`), `host_ms` the kernel's time as a caller sees
    it, host enqueue included; `per_leaf` the same leaves one call (and
    launch) each.  A prefilled timing keeps its launches (reps x launches
    per call) below ~1000, the depth of the card's launch queue: past it
    the host blocks, and the card catches up before the host has enqueued
    everything."""
    gen = torch.Generator(DEV).manual_seed(len(xs))
    k = xs[0].shape[0]
    max_abs = 0.0
    for case, w in k3_weight_cases(k, gen):
        before = fedavg_aggregate_leaves.launches
        got = fedavg_aggregate_leaves(xs, w)
        torch.cuda.synchronize()
        launches = fedavg_aggregate_leaves.launches - before
        for g, x in zip(got, xs):
            want = fedavg_agg_plain(x, w)
            err = float((g - want).abs().max())
            max_abs = max(max_abs, err)
            if not torch.equal(g, want):
                raise AssertionError(f"K3 {label} {case}: kernel differs from plain "
                                     f"(max_abs {err:.3e})")
            if case == "all_zero" and bool(g.any()):
                raise AssertionError(f"K3 {label}: all-zero weights did not give 0")
            if case == "one_slot" and not torch.equal(g, x[k // 2]):
                raise AssertionError(f"K3 {label}: one slot did not give that slot")
        if launches != 1:
            raise AssertionError(f"K3 {label}: {launches} launches for one aggregation")
    w = k3_weight_cases(k, gen)[0][1]
    w_hat = w / w.sum()
    host_ms = time_ms(lambda: fedavg_aggregate_leaves(xs, w), reps)
    ms = time_ms(lambda: fedavg_aggregate_leaves(xs, w), reps, prefill=True)
    leaf_host_ms = time_ms(lambda: [fedavg_aggregate(x, w) for x in xs], reps)
    leaf_ms = time_ms(lambda: [fedavg_aggregate(x, w) for x in xs], reps, prefill=True)
    plain_ms = time_ms(lambda: [fedavg_agg_plain(x, w) for x in xs], plain_reps,
                       prefill=True)
    library_ms = time_ms(lambda: [torch.matmul(w_hat, x) for x in xs], reps, prefill=True)
    n_total = sum(x.shape[1] for x in xs)
    b_ms, b_by = bound_ms(2 * k * n_total, (k + 1) * n_total * 4, torch.float32)
    line(f"K3 {label}: K={k} N={'+'.join(str(x.shape[1]) for x in xs)} launches=1 "
         f"max_abs_err={max_abs:.3e} bitwise_equal_plain=True kernel_ms={ms:.4f} "
         f"kernel_ms_with_host_enqueue={host_ms:.4f} "
         f"plain_ms={plain_ms:.4f} library_ms(matmul)={library_ms:.4f} "
         f"bound_ms={b_ms:.5f} ({b_by}) achieved_GB/s={(k + 1) * n_total * 4 / ms / 1e6:.1f}")
    if len(xs) > 1:
        line(f"  per leaf, one launch each ({len(xs)} launches): kernel_ms={leaf_ms:.4f} "
             f"kernel_ms_with_host_enqueue={leaf_host_ms:.4f}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


# ---------------------------------------------------------------------------
# K4: flash attention; K5: the WKV6 recurrence
# ---------------------------------------------------------------------------

def attn_pairs(sq: int, sk: int, window: int) -> int:
    """(query, key) pairs the causal (and window) mask leaves, per head."""
    i = torch.arange(sq, dtype=torch.int64)[:, None] + (sk - sq)
    j = torch.arange(sk, dtype=torch.int64)[None, :]
    keep = j <= i
    if window > 0:
        keep &= j > i - window
    return int(keep.sum())


def sdpa_call(q, k, v, window: int):
    """One PyTorch call for the same function, as a yardstick only: causal
    SDPA with GQA; an explicit boolean mask where the queries are
    right-aligned (Sq < Sk) or a window applies, since SDPA's is_causal
    aligns them top-left."""
    import torch.nn.functional as F
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    sq, sk = q.shape[1], k.shape[1]
    if sq == sk and window == 0:
        kw = dict(is_causal=True)
    else:
        i = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        j = torch.arange(sk, device=q.device)[None, :]
        kw = dict(attn_mask=(j <= i) & ((j > i - window) if window > 0 else True))
    # Output in the model's (B, S, H, D) layout, as a view.
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, enable_gqa=True,  # noqa: E731
                                                  **kw).transpose(1, 2)


def check_k4(b, sq, sk, hq, hkv, d, window, dtype, label: str, reps: int) -> dict:
    """The kernel against its plain version on random inputs: both take
    f32 scores, softmax and P.V and cast once, so f32 must agree to 1e-5
    and bf16 to one ulp (plus that 1e-5 floor near 0)."""
    gen = torch.Generator(DEV).manual_seed(sq * 7 + window)
    q = torch.randn(b, sq, hq, d, generator=gen, device=DEV).to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=gen, device=DEV).to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=gen, device=DEV).to(dtype)
    got = flash_attention(q, k, v, causal=True, window=window)
    want = flash_attention_plain(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    diff = (got.double() - want.double()).abs()
    if dtype == torch.float32:
        ok, limit = bool(diff.max() <= 1e-5), "1e-5"
    else:
        mag = torch.maximum(got.double().abs(), want.double().abs()).clamp_min(2.0**-126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        ok, limit = bool((diff <= ulp + 1e-5).all()), "1 bf16 ulp + 1e-5"
    lib = sdpa_call(q, k, v, window)
    lib_err = float((lib().double() - want.double()).abs().max())
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True, window=window), reps, prefill=True)
    host_ms = time_ms(lambda: flash_attention(q, k, v, causal=True, window=window), reps)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, causal=True, window=window),
                       max(2, reps // 4), prefill=True)
    library_ms = time_ms(lib, reps, prefill=True)
    pairs = attn_pairs(sq, sk, window)
    elt = q.element_size()
    b_ms, b_by = bound_ms(4 * b * hq * d * pairs, (2 * b * sq * hq + 2 * b * sk * hkv) * d * elt,
                          dtype)
    max_abs = float(diff.max())
    line(f"K4 {label} {str(dtype)[6:]}: B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} D={d} "
         f"window={window} max_abs_err={max_abs:.3e} (limit {limit}) sdpa_max_abs_err="
         f"{lib_err:.3e} kernel_ms={ms:.4f} kernel_ms_with_host_enqueue={host_ms:.4f} "
         f"plain_ms={plain_ms:.4f} library_ms(sdpa)={library_ms:.4f} bound_ms={b_ms:.5f} "
         f"({b_by}) achieved_TFLOP/s={4 * b * hq * d * pairs / ms / 1e9:.2f}")
    if not ok:
        raise AssertionError(f"K4 {label} {dtype}: kernel disagrees with plain")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def check_k5(b, t, h, hs, label: str, reps: int) -> dict:
    """The kernel against its plain version with random non-zero u and
    initial state: both make the same f32 operations in the same order, so
    they should agree to the bit; the gate is y and the final state within
    1e-5 of their scale."""
    gen = torch.Generator(DEV).manual_seed(t)
    r, k, v = (torch.randn(b, t, h, hs, generator=gen, device=DEV) for _ in range(3))
    w = torch.exp(-torch.exp(torch.rand(b, t, h, hs, generator=gen, device=DEV) * 7 - 7))
    u = torch.randn(h, hs, generator=gen, device=DEV)
    s0 = torch.randn(b, h, hs, hs, generator=gen, device=DEV)
    y, s = wkv6(r, k, v, w, u, s0)
    y_p, s_p = wkv6_plain(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    rel_y = float((y - y_p).abs().max() / y_p.abs().max())
    rel_s = float((s - s_p).abs().max() / s_p.abs().max())
    ms = time_ms(lambda: wkv6(r, k, v, w, u, s0), reps, prefill=True)
    host_ms = time_ms(lambda: wkv6(r, k, v, w, u, s0), reps)
    plain_ms = time_ms(lambda: wkv6_plain(r, k, v, w, u, s0), 2)
    # 7 flops per (t, i, j): k*v, u*kv, + S, r*(.), + y, w*S, + kv.
    b_ms, b_by = bound_ms(7 * b * t * h * hs * hs,
                          (5 * b * t * h * hs + 2 * b * h * hs * hs + h * hs) * 4, torch.float32)
    max_abs = max(float((y - y_p).abs().max()), float((s - s_p).abs().max()))
    bitwise = bool(torch.equal(y, y_p) and torch.equal(s, s_p))
    line(f"K5 {label}: B={b} T={t} H={h} hs={hs} rel_err(y)={rel_y:.3e} rel_err(state)="
         f"{rel_s:.3e} (limit 1e-5 of scale) bitwise_equal_plain={bitwise} "
         f"max_abs_err={max_abs:.3e} kernel_ms={ms:.4f} "
         f"kernel_ms_with_host_enqueue={host_ms:.4f} plain_ms={plain_ms:.4f} "
         f"library_ms=None bound_ms={b_ms:.5f} ({b_by})")
    if not (rel_y < 1e-5 and rel_s < 1e-5):
        raise AssertionError(f"K5 {label}: kernel disagrees with plain")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


# ---------------------------------------------------------------------------
# the main paths
# ---------------------------------------------------------------------------

COUNTERS = {"polyblock_fused": polyblock_solve_fused,
            "polyblock_project": polyblock_project,
            "fedavg_agg": fedavg_aggregate_leaves,
            "flash_attention": flash_attention,
            "rwkv6_wkv": wkv6}


def run_on_card(cfg, run=run_simulation, **kw):
    """One run of `run(cfg, device=DEV, **kw)` on the card with every
    launch counter (and the host-read counter) set to 0 just before it;
    returns its result, wall seconds, the launch counts and the host reads
    of that run."""
    for fn in COUNTERS.values():
        fn.launches = 0
    host_int.syncs = 0
    t0 = time.perf_counter()
    hist = run(cfg, device=DEV, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return hist, wall, {name: fn.launches for name, fn in COUNTERS.items()}, host_int.syncs


def run_name(run, kw: dict) -> str:
    """A run's label in the output: the entry point's keyword arguments,
    "hier" before them for the hierarchy."""
    name = " ".join(f"{k}={v}" for k, v in kw.items()) or "engine=loop"
    return name if run is run_simulation else "hier " + name


def max_rel(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
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


def profile_call(name: str, fn, focus: tuple[str, ...] = ()) -> dict:
    """Where one warm call's time goes: `fn()` under torch.profiler: wall
    time, the card's busy time (the sum of its kernels' self time; one
    stream, so kernels do not overlap), its idle share, the kernel count,
    and the kernels that take most of it; for each name part in `focus`,
    the launches and summed device time of the kernels whose name holds
    it.  Returns the idle share and each focus part's device ms (None where
    the profiler saw no such kernel)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        line(f"profile {name}: wall_s={wall:.3f}; device time not measured (no device events)")
        return dict(idle=None, **{part: None for part in focus})
    idle = 1 - busy_ms / 1e3 / wall
    line(f"profile {name}: wall_s={wall:.3f} (profiled) device_busy_ms="
         f"{busy_ms:.2f} device_idle_share={idle:.4f} "
         f"kernel_launches={sum(e.count for e in kernels)}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        line(f"  {e.self_device_time_total / 1e3:8.3f} ms  {e.count:6d}x  {e.key[:90]}")
    out = dict(idle=idle)
    for part in focus:
        mine = [e for e in kernels if part in e.key]
        ms = sum(e.self_device_time_total for e in mine) / 1e3
        out[part] = ms if mine else None
        line(f"  kernels named *{part}*: launches={sum(e.count for e in mine)} device_ms="
             f"{ms:.4f} (" + ", ".join(f"{e.key[:60]} x{e.count}" for e in mine) + ")")
    return out


def profile_run(cfg, focus: tuple[str, ...] = (), run=run_simulation, **kw) -> None:
    """`profile_call` of one run of `run(cfg, device=DEV, **kw)`, after an
    unprofiled warm-up run."""
    run(cfg, device=DEV, **kw)
    profile_call(f"{run_name(run, kw)} rounds={cfg.rounds}",
                 lambda: run(cfg, device=DEV, **kw), focus)


def count_syncs(cfg, run=run_simulation, **kw) -> None:
    """Every host sync of one run of `run(cfg, device=DEV, **kw)`, as
    torch's sync debug mode reports them (one warning per synchronizing
    call), by the source line that made it, beside the engine's own count
    of its host reads (`host_int`)."""
    host_int.syncs = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run(cfg, device=DEV, **kw)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    by_line = collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in syncs)
    name = run_name(run, kw)
    line(f"syncs {name} rounds={cfg.rounds}: {len(syncs)} synchronizing calls "
         f"({len(syncs) / cfg.rounds:.2f} per round); host_int reads={host_int.syncs}; "
         "by source line: " + ", ".join(f"{k} x{v}" for k, v in by_line.most_common(8)))


# ---------------------------------------------------------------------------
# the hierarchy's main paths (multi-cell)
# ---------------------------------------------------------------------------

def hier_sim(cfg: HierSimConfig, device, engine: str = "scan",
             ra_solver: str = "fused") -> dict:
    """One hierarchy run through the entry point a user calls
    (`run_hierarchical` for the loop engine, `run_hier_many` otherwise), as
    per-cell traces: tx and AoU (rounds, C, N), losses, latencies, the
    async engine's commits at both tiers, and the SimHistory (`hist`; None
    on the loop engine)."""
    if engine == "loop":
        out = run_hierarchical(cfg, engine="loop", device=device)
        return dict(tx=out["tx"], age=out["age"], loss=out["loss"], acc=out["accuracy"],
                    latency=out["latency"], hist=None)
    h = run_hier_many([cfg], engine=engine, ra_solver=ra_solver, device=device)[0]
    shape = (cfg.rounds, cfg.n_cells, cfg.devices_per_cell)
    out = dict(tx=h.tx_trace.reshape(shape), age=h.age_trace.reshape(shape),
               loss=h.global_loss, acc=h.accuracy, latency=h.latency_all, hist=h)
    if h.commit_trace is not None:
        out.update(committed=h.commit_trace.reshape(shape),
                   cell_committed=h.async_trace["cell_committed"])
    return out


def hier_k3_expected(cfg: HierSimConfig, engine: str, out: dict) -> tuple[int, str]:
    """The K3 launches a run's traces imply, and how.  Every aggregation is
    one grouped K3 launch.  loop: one per (round, cell) in which the cell
    trained, and a global one per round in which any cell trained (it
    stacks only those cells); scan: one per (round, cell) in which the cell
    trained, and a global one every round over all C cell slots.  async:
    the count does not depend on the traces, by design: every event makes
    one buffered commit per cell and one at the global tier whether or not
    anything commits (a commit that takes nothing is an exact identity
    select, so the engine makes no host read to skip it), so rounds x
    (C + 1).  The check then shows only that each event launched C + 1
    aggregations; the cell-tier and global commits of the traces are
    printed beside it, and each is one of those launches."""
    trained = out["tx"].any(axis=2)                     # (rounds, C)
    if engine == "loop":
        any_t = int(trained.any(axis=1).sum())
        return int(trained.sum()) + any_t, f"{int(trained.sum())} cell + {any_t} global"
    if engine == "scan":
        return (int(trained.sum()) + cfg.rounds,
                f"{int(trained.sum())} cell + {cfg.rounds} global")
    return (cfg.rounds * (cfg.n_cells + 1),
            f"{cfg.rounds} events x ({cfg.n_cells} cells + 1 global); cell-tier commits "
            f"{int(out['committed'].any(axis=2).sum())}, global commits "
            f"{int(out['cell_committed'].sum())}")


def hier_k2_expected(cfg: HierSimConfig) -> int:
    """K2 launches of a `ra_solver="step"` run: the step driver projects
    (1, 1) once, then the children once per iteration of its slowest pair
    (the iteration counts of the same solve on the CPU)."""
    prep = hier._prepare_hier(cfg, torch.device("cpu"))
    (ras,), _ = hier._solve_hier_horizons([prep], "step", torch.device("cpu"))
    return 1 + max(int(ra.iterations.max()) for ra in ras)


def drive_hier(cfg: HierSimConfig, engine: str, need: tuple[str, ...],
               ra_solver: str = "fused") -> tuple[dict, dict]:
    """Drive one hierarchy path on the card twice and once on the CPU:
    traces equal to the CPU run's, latency within 1e-6 and losses within
    1e-4 of it, each kernel in `need` launched, K1 exactly once on a fused
    run, K2 as often as the step driver iterates on a step run, and K3
    exactly as often as the traces imply (`hier_k3_expected`)."""
    out, wall, launches, syncs = run_on_card(cfg, hier_sim, engine=engine, ra_solver=ra_solver)
    again, warm_wall, _, _ = run_on_card(cfg, hier_sim, engine=engine, ra_solver=ra_solver)
    t0 = time.perf_counter()
    ref = hier_sim(cfg, "cpu", engine, ra_solver)
    cpu_wall = time.perf_counter() - t0
    name = f"engine={engine}" + (f" ra_solver={ra_solver}" if ra_solver != "fused" else "")
    line(f"main path hier {name} cells={cfg.n_cells}x{cfg.devices_per_cell} devices, "
         f"{cfg.subchannels_per_cell} sub-channels each, scenario={cfg.scenario} "
         f"coupling={cfg.cell_coupling} aggregation={cfg.aggregation}/"
         f"{cfg.global_aggregation} rounds={cfg.rounds}: launches "
         + " ".join(f"{k}={v}" for k, v in launches.items())
         + f"; host reads={syncs} ({syncs / cfg.rounds:.2f} per round); gpu wall_s first "
         f"run={wall:.3f}, second run={warm_wall:.3f}; cpu wall_s={cpu_wall:.3f}"
         + (f"; plan_wall_s gpu={out['hist'].plan_wall_s:.4f} cpu={ref['hist'].plan_wall_s:.4f}"
            if out["hist"] is not None else ""))
    line("  loss: " + " ".join(f"{x:.4f}" for x in out["loss"]))
    line("  acc:  " + " ".join(f"{x:.3f}" for x in out["acc"]))
    same = {f: np.array_equal(out[f], ref[f])
            for f in ("tx", "age", "committed", "cell_committed") if f in ref}
    lat_rel = max_rel(out["latency"], ref["latency"])
    loss_rel = max_rel(out["loss"], ref["loss"])
    k3_want, k3_how = hier_k3_expected(cfg, engine, out)
    k1_want = 1 if ra_solver == "fused" else 0
    k2_want = hier_k2_expected(cfg) if ra_solver == "step" else 0
    line("  " + "; ".join(f"{f} == cpu: {v}" for f, v in same.items())
         + f"; latency max_rel vs cpu: {lat_rel:.3e} (limit 1e-6); loss max_rel vs cpu: "
         f"{loss_rel:.3e} (limit 1e-4); transmissions: {int(out['tx'].sum())}")
    line(f"  K1 launches={launches['polyblock_fused']} (expected {k1_want}); K2 launches="
         f"{launches['polyblock_project']} (expected {k2_want}); K3 launches="
         f"{launches['fedavg_agg']} (the traces imply {k3_want}: {k3_how})")
    for kernel in need:
        if launches[kernel] < 1:
            raise AssertionError(f"{kernel} was not launched on the hierarchy path {name}")
    if (launches["polyblock_fused"], launches["polyblock_project"],
            launches["fedavg_agg"]) != (k1_want, k2_want, k3_want):
        raise AssertionError(f"hier {name}: K1/K2/K3 launches differ from the expected counts")
    if not (np.all(np.isfinite(out["loss"])) and out["loss"].shape == (cfg.rounds,)):
        raise AssertionError("hier: losses are not finite / not one per round")
    if not out["loss"][-1] < out["loss"][0]:
        raise AssertionError("hier: training did not lower the loss")
    if not np.array_equal(again["tx"], out["tx"]):
        raise AssertionError("hier: two runs of the same seed on the card differ in tx")
    if not all(same.values()):
        raise AssertionError(f"hier {name}: traces differ from the CPU run")
    if not (lat_rel <= 1e-6 and loss_rel <= 1e-4):
        raise AssertionError(f"hier {name}: latency or loss too far from the CPU run")
    return out, launches


# ---------------------------------------------------------------------------
# the sweep harness and the sustained service
# ---------------------------------------------------------------------------

# The paper's four DS baselines at `examples/torch_reproduce_figures.py`'s
# default widths (mnist, N 20, K 4, 500 samples, eval every 5 rounds), crossed
# with aggregation sync / async and cell counts 1 / 2, at 30 rounds.
SWEEP_SPEC = dict(name="fig3_convergence", datasets="mnist", ds=PAPER_BASELINE_DS,
                  aggregation=("sync", "async"), cell_counts=(1, 2), seeds=(0, 1),
                  rounds=30, n_devices=20, n_subchannels=4, target_loss=1.0,
                  overrides={"n_samples": 500, "eval_every": 5})
# `python -m repro_torch.service.run --ra mo` at its defaults.
SERVICE_SIM = dict(dataset="mnist", n_devices=64, n_subchannels=16, n_samples=128,
                   batch=16, local_steps=1, scenario="churn", aggregation="async",
                   policy=RoundPolicy(ra="mo"))
SERVICE_SEGMENTS = 4


def k1_bound(label: str, beta64, h264, e64, cfg) -> dict:
    """K1 at one path's pairs (float64): its output against the plain
    float64 version on the same pairs, under phase 4's contract (`check_k1`:
    > 97% of pairs on the plain version's trajectory, within 1e-9 relative
    there, |dT| <= eps on the rest); its bound: the operations this data
    needs (`k1_ops`, from the solve's own iteration counts) at the card's
    peak rate, against the bytes at its memory rate; the longest pair's
    chain (`chain_calls`) at the latency per evaluation the one-lane
    schedule's time implies; and the time of the schedule the lanes rule
    picks."""
    args = (beta64, h264, e64)
    lanes = coop_lanes(beta64.shape[0])
    got = polyblock_solve_fused(*args, cfg)
    want = polyblock_solve_plain(*args, cfg)
    torch.cuda.synchronize()
    share, errs, dt, n_rest = trajectory(got, want)
    max_abs = max(float((g - w).abs().max()) for g, w in zip(got[:3], want[:3]))
    iters = got[3]
    ms = time_ms(lambda: polyblock_solve_fused(*args, cfg), 10, prefill=True)
    ms1 = time_ms(lambda: polyblock_solve_fused(*args, cfg, lanes=1), 10, prefill=True)
    per_call_ns = ms1 / chain_calls(*args, iters, cfg, 1) * 1e6
    crit_ms = chain_calls(*args, iters, cfg, lanes) * per_call_ns * 1e-6
    b_ms, b_by = bound_ms(k1_ops(*args, iters, cfg), beta64.shape[0] * (6 * 8 + 4),
                          torch.float64)
    line(f"K1 bound at {label}: pairs={beta64.shape[0]} max_iters={int(iters.max())} "
         f"lanes={lanes} kernel_ms={ms:.4f} (lanes=1 {ms1:.4f}) bound_ms={b_ms:.5f} "
         f"({b_by}) critical_path_ms={crit_ms:.4f} [{CARD}]")
    line(f"  vs plain float64: {fmt(share, errs, dt, n_rest)} (limits: > 0.97, 1e-9, eps); "
         f"max_abs_err(tau,p,T)={max_abs:.3e}")
    if not (share > 0.97 and max(errs) < 1e-9 and dt <= EPS + 1e-6):
        raise AssertionError(f"K1 at {label}: kernel disagrees with plain")
    return dict(ms=ms, bound_ms=b_ms, bound_by=b_by, critical_path_ms=crit_ms, lanes=lanes,
                max_abs_err=max_abs)


def hier_pairs(cfg: HierSimConfig):
    """The pairs the hierarchy's one Γ solve hands K1: every cell's
    (rounds, K, N) horizon, Prop-1 filtered."""
    prep = hier._prepare_hier(cfg, torch.device("cpu"))
    return (*feasible_pairs(prep.beta[:, None, None, :], prep.h2_all,
                            prep.emax_all[:, :, None, :], prep.wcfg), prep.wcfg)


def sweep_k1_expected(spec: SweepSpec) -> int:
    """K1 launches of one `run_sweep` of `spec`, from its axes: the sweep
    hands all flat cells to one `run_many` call and all multi-cell ones to
    one `run_hier_many` call.  `run_many` concatenates every MO world that
    shares one wireless setting into one solver call, and the spec has one
    (a single dataset, N, K and scenario); `run_hier_many` solves each
    multi-cell world once, one per (seed, cell count) here.  Each call
    launches K1 once, since every world of this size has a feasible pair."""
    axes = (spec.datasets, spec.n_devices, spec.n_subchannels, spec.scenarios,
            spec.global_aggregation)
    if (any(len(a) != 1 for a in axes)
            or {k for k, _ in spec.overrides} - {"n_samples", "eval_every"}):
        raise AssertionError("sweep_k1_expected counts a spec of one wireless setting")
    if "mo" not in spec.ra:
        return 0
    flat = 1 in spec.cell_counts
    worlds = len(spec.seeds) * len([c for c in spec.cell_counts if c > 1])
    return int(flat) + worlds


def sweep_k3_expected(cfg, hist) -> int:
    """K3 launches of one sweep cell, from its traces: one per aggregation
    — flat scan: each round with a transmission; flat async: each event;
    a hierarchy: `hier_k3_expected`'s rules."""
    if isinstance(cfg, HierSimConfig):
        shape = (cfg.rounds, cfg.n_cells, cfg.devices_per_cell)
        out = dict(tx=hist.tx_trace.reshape(shape))
        if hist.commit_trace is None:
            return hier_k3_expected(cfg, "scan", out)[0]
        out.update(committed=hist.commit_trace.reshape(shape),
                   cell_committed=hist.async_trace["cell_committed"])
        return hier_k3_expected(cfg, "async", out)[0]
    return cfg.rounds if hist.commit_trace is not None else int(hist.tx_trace.any(axis=1).sum())


def solo(cfg, device):
    """One sweep cell's config through the solo entry point."""
    if isinstance(cfg, HierSimConfig):
        return run_hier_many([cfg], engine="scan", device=device)[0]
    return run_simulation(cfg, engine="scan", device=device)


def sweep_phase() -> dict:
    """The sweep of `SWEEP_SPEC` through `run_sweep(engine="scan")` on the
    card, writing its record and gallery into a temporary directory: K1
    and K3 launched as often as the code implies (`sweep_k1_expected`,
    `sweep_k3_expected`); one cell per (aggregation, cell count) bitwise
    equal to its solo run on the card, and its tx and AoU traces equal to
    the same solo run on the CPU."""
    spec = SweepSpec(**SWEEP_SPEC)
    with tempfile.TemporaryDirectory() as tmp:
        res, wall, launches, syncs = run_on_card(spec, run_sweep, engine="scan",
                                                 results_root=tmp, figures=True)
        svgs = sorted(p.name for p in (res.out_dir / "figures").glob("*.svg"))
    cells, hists = res.cells, res.histories
    k1_want = sweep_k1_expected(spec)
    k3_want = sum(sweep_k3_expected(c.config, h) for c, h in zip(cells, hists))
    rounds = sum(c.config.rounds for c in cells)
    line(f"main path sweep {spec.name}: {len(cells)} cells ({len(spec.policies)} policies x "
         f"aggregation {spec.aggregation} x cell_counts {spec.cell_counts} x seeds "
         f"{spec.seeds}), mnist N={spec.n_devices[0]} K={spec.n_subchannels[0]} "
         f"rounds={spec.rounds}, engine=scan: wall_s={res.record['wall_s']:.3f} (call "
         f"{wall:.3f}, incl. record and gallery); launches "
         + " ".join(f"{k}={v}" for k, v in launches.items())
         + f"; host reads={syncs} ({syncs / rounds:.2f} per cell round); env "
         f"{res.record['env']} [{CARD}]")
    line(f"  K1 launches={launches['polyblock_fused']} (expected {k1_want}: one per "
         f"solver call); K3 launches={launches['fedavg_agg']} (the traces imply {k3_want}); "
         f"gallery: {len(svgs)} SVG files ({', '.join(svgs[:4])}, ...)")
    for c in res.record["cells"][:: len(spec.seeds) * len(spec.policies)]:
        m = c["metrics"]
        line(f"  {c['id']}: final_loss={m['final_loss']:.4f} rounds_to_target="
             f"{m['rounds_to_target']} time_to_target_s={m['time_to_target_s']} "
             f"utilization={m['mean_subchannel_utilization']:.4f} cumulative_latency_s="
             f"{m['cumulative_latency_s']:.3f}")
    if (launches["polyblock_fused"], launches["fedavg_agg"]) != (k1_want, k3_want):
        raise AssertionError("sweep: K1/K3 launches differ from the expected counts")
    if launches["polyblock_project"]:
        raise AssertionError("sweep: K2 launched on the fused path")
    if len(svgs) < 4 * 4:
        raise AssertionError(f"sweep: the gallery holds {len(svgs)} figures")
    for h in hists:
        if not (np.all(np.isfinite(h.global_loss)) and h.tx_trace.any()):
            raise AssertionError("sweep: a cell's losses are not finite or nothing trained")
    by_group: dict = {}
    for c, h in zip(cells, hists):
        by_group.setdefault((c.config.aggregation, getattr(c.config, "n_cells", 1)),
                            []).append((c, h))
    for (agg, n_cells), members in by_group.items():
        cell, hist = members[0]
        mean0 = np.mean([h.global_loss[0] for _, h in members])
        mean1 = np.mean([h.global_loss[-1] for _, h in members])
        if not mean1 < mean0:
            raise AssertionError(f"sweep {agg} C={n_cells}: training did not lower the loss")
        assert_bitwise(hist, solo(cell.config, DEV),
                       f"sweep cell {cell.cell_id} vs its solo run on the card")
        ref = solo(cell.config, "cpu")
        same = {f: np.array_equal(getattr(hist, f), getattr(ref, f))
                for f in ("tx_trace", "age_trace", "commit_trace")
                if getattr(ref, f) is not None}
        line(f"  {cell.cell_id} vs the cpu: " + "; ".join(f"{f} == cpu: {v}"
                                                         for f, v in same.items())
             + f"; loss max_rel vs cpu: {max_rel(hist.global_loss, ref.global_loss):.3e}")
        if not all(same.values()):
            raise AssertionError(f"sweep cell {cell.cell_id}: traces differ from the CPU run")
    return dict(launches=launches, wall_s=res.record["wall_s"])


def service_config(**kw) -> ServiceConfig:
    return ServiceConfig(sim=SimConfig(**SERVICE_SIM), **kw)


def service_k1_expected(cfg: ServiceConfig, segments: int) -> int:
    """K1 launches of `segments` segments: one per segment with a feasible
    pair, replayed from a fresh stream of the same seed."""
    sim = cfg.sim
    stream = ScenarioStream(sim.seed, sim.wireless(), sim.scenario)
    n = 0
    for _ in range(segments):
        tr = stream.next_segment(cfg.segment_events)
        e_max = np.broadcast_to(tr.e_max_j[:, None, :], tr.h2_all.shape)
        n += bool((~is_infeasible(tr.h2_all, sim.wireless(), e_max)).any())
    return n


def service_phase() -> dict:
    """The sustained service at `service/run.py`'s defaults with `--ra mo`:
    one warm-up and `SERVICE_SEGMENTS` measured segments of 100 events,
    closed loop, with K1 once per segment and K3 once per event; one more
    segment under the profiler; then, on fresh services, 2 chained segments
    of 50 events bitwise equal to one of 100, that segment against the same
    segment on the CPU (dispatches, commits, AoU and the buffer exact,
    latency within 1e-6, loss within 1e-4), one segment with
    ra_solver="step" (K2) whose dispatches equal the fused segment's, and
    one open-loop segment at half the measured closed-loop rate."""
    cfg = service_config()
    sim = cfg.sim
    svc = SustainedService(cfg, device=DEV)
    rec, wall, launches, syncs = run_on_card(SERVICE_SEGMENTS,
                                             lambda n, device: svc.serve(n))
    events = svc.events_served
    s = rec["summary"]
    k1_want = service_k1_expected(cfg, cfg.warmup_segments + SERVICE_SEGMENTS)
    line(f"main path service: mnist N={sim.n_devices} K={sim.n_subchannels} "
         f"samples={sim.n_samples} batch={sim.batch} scenario={sim.scenario} ra=mo, "
         f"{cfg.warmup_segments} warm-up + {SERVICE_SEGMENTS} segments of "
         f"{cfg.segment_events} events, closed loop: events/s="
         f"{s['throughput_events_per_s']:.3f} p50={s['latency_s']['p50']:.4f}s "
         f"p95={s['latency_s']['p95']:.4f}s p99={s['latency_s']['p99']:.4f}s SLO "
         f"attained={s['slo']['attained']:.3f} at {s['slo']['budget_s']:g}s; warm-up "
         f"segment {rec['walls']['warmup_s'][0]:.3f}s, segments "
         + " ".join(f"{w:.3f}" for w in rec["walls"]["segment_s"])
         + f"s; call wall_s={wall:.3f} [{CARD}]")
    line(f"  launches " + " ".join(f"{k}={v}" for k, v in launches.items())
         + f"; K1 launches={launches['polyblock_fused']} (expected {k1_want}: one per "
         f"segment with a feasible pair); K3 launches={launches['fedavg_agg']} (expected "
         f"{events}: one per event); host reads={syncs} ({syncs / events:.2f} per event); "
         f"mean pending {s['buffer']['mean_pending']:.3f}; steady-state loss "
         + " ".join(f"{x:.4f}" for x in rec["steady_state"]["global_loss"]))
    if (launches["polyblock_fused"], launches["fedavg_agg"]) != (k1_want, events):
        raise AssertionError("service: K1/K3 launches differ from the expected counts")
    losses = np.asarray(rec["steady_state"]["global_loss"])
    if not (np.all(np.isfinite(losses)) and losses.shape == (SERVICE_SEGMENTS,)):
        raise AssertionError("service: steady-state losses are not finite / one per segment")
    if not losses[-1] < losses[0]:
        raise AssertionError("service: training did not lower the loss")
    k1_before = polyblock_solve_fused.launches
    prof = profile_call(f"service segment ({cfg.segment_events} events)", svc.run_segment,
                        focus=("solve_", "agg_leaves"))
    line(f"  K1 launches in the profiled segment: {polyblock_solve_fused.launches - k1_before}")
    k1_ms = "not measured" if prof["solve_"] is None else f"{prof['solve_']:.4f}"
    idle = "not measured" if prof["idle"] is None else f"{prof['idle']:.4f}"
    line(f"  K1 device ms per segment (profiler)={k1_ms}; idle share of the segment={idle} "
         f"[{CARD}]")

    halves = SustainedService(service_config(segment_events=50, eval_every_events=50),
                              device=DEV)
    whole = SustainedService(service_config(eval_every_events=50), device=DEV)
    parts = [halves.run_segment() for _ in range(2)]
    one = whole.run_segment()
    diff = [k for k in one if not np.array_equal(np.concatenate([p[k] for p in parts]),
                                                 one[k])]
    line(f"service on the card: 2 chained segments of 50 events vs one of 100, bitwise "
         f"equal on every key ({len(one)}): {not diff}" + (f" (differ: {diff})" if diff else ""))
    if diff:
        raise AssertionError(f"service: chained segments differ on {diff}")

    t0 = time.perf_counter()
    ref = SustainedService(service_config(eval_every_events=50), device="cpu").run_segment()
    cpu_wall = time.perf_counter() - t0
    same = {k: bool(np.array_equal(one[k], ref[k]))
            for k in ("transmitted", "committed", "age", "n_pending", "selected", "overflow")}
    lat_rel = max_rel(one["latency"], ref["latency"])
    loss_rel = max_rel(one["loss"], ref["loss"])
    line(f"service segment of 100 events, card vs cpu: " + "; ".join(
        f"{k} == cpu: {v}" for k, v in same.items())
        + f"; latency max_rel vs cpu: {lat_rel:.3e} (limit 1e-6); loss max_rel vs cpu: "
        f"{loss_rel:.3e} (limit 1e-4); transmissions: {int(one['transmitted'].sum())}; "
        f"cpu wall_s={cpu_wall:.3f}")
    if not all(same.values()):
        raise AssertionError("service: the card's segment differs from the CPU's")
    if not (lat_rel <= 1e-6 and loss_rel <= 1e-4 and one["transmitted"].any()):
        raise AssertionError("service: latency or loss too far from the CPU's segment")

    step = SustainedService(cfg, ra_solver="step", device=DEV)
    ys, step_wall, step_launches, _ = run_on_card(None, lambda _, device: step.run_segment())
    same_tx = bool(np.array_equal(ys["transmitted"], one["transmitted"]))
    line(f"service segment ra_solver=step: launches "
         + " ".join(f"{k}={v}" for k, v in step_launches.items())
         + f"; wall_s={step_wall:.3f}; dispatches equal to the fused segment's: {same_tx} "
         f"[{CARD}]")
    if step_launches["polyblock_project"] < 1 or step_launches["polyblock_fused"]:
        raise AssertionError("service: the step segment did not run on K2 alone")
    if not same_tx:
        raise AssertionError("service: the step segment's dispatches differ from the fused")

    rate = 0.5 * s["throughput_events_per_s"]
    open_loop = SustainedService(service_config(target_rate_events_per_s=rate,
                                                warmup_segments=0), device=DEV)
    o = open_loop.serve(1)["summary"]
    line(f"service open loop at {rate:.3f} events/s (half the closed loop's), 1 segment: "
         f"events/s={o['throughput_events_per_s']:.3f} p50={o['latency_s']['p50']:.4f}s "
         f"p99={o['latency_s']['p99']:.4f}s SLO attained={o['slo']['attained']:.3f} "
         f"[{CARD}]")
    if not 0 < o["throughput_events_per_s"] <= rate:
        raise AssertionError("service: the open loop served faster than its arrivals")
    return dict(launches=launches, step_launches=step_launches, k1_ms=prof["solve_"],
                idle=prof["idle"], pairs=service_pairs(cfg))


def service_pairs(cfg: ServiceConfig):
    """The pairs of the service's first segment that K1 is handed."""
    sim = cfg.sim
    beta = sim_mod._sample_dataset(sim, np.random.default_rng(sim.seed),
                                   torch.device("cpu"))[2]
    tr = ScenarioStream(sim.seed, sim.wireless(), sim.scenario).next_segment(
        cfg.segment_events)
    return (*feasible_pairs(beta[None, None, :], tr.h2_all, tr.e_max_j[:, None, :],
                            sim.wireless()), sim.wireless())


# ---------------------------------------------------------------------------
# the serving paths (model zoo)
# ---------------------------------------------------------------------------

SERVE = dict(batch=4, prompt_len=512, new_tokens=32, seed=0)


def serve_phase(arch: str, kernel: str, expect: int) -> dict:
    """Serve `arch` at full width and depth on the kernel path: random
    weights from the seed, the launch counters set to 0 just before
    serve_loop and read just after; `kernel` must have launched exactly
    `expect` times.  Then prefill logits on the kernel path against the
    "ref" path on the same weights and prompt (4e-2 of the scale, the JAX
    package's serving tolerance), a warm second run under torch's sync
    debug mode (every host sync, by source line) and a third under
    torch.profiler (the card's busy time and idle share)."""
    base = get_config(arch)
    cfg = dataclasses.replace(base, attn_impl="pallas", rwkv_wkv_impl="pallas")
    ref_cfg = dataclasses.replace(base, attn_impl="ref", rwkv_wkv_impl="ref")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(DEV).manual_seed(SERVE["seed"]))
    torch.cuda.synchronize()
    line(f"serve {arch}: init_params {time.perf_counter() - t0:.2f}s; "
         f"memory allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    for fn in COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    first = serve_loop(cfg, device=DEV, params=params, **SERVE)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    line(f"main path serve {arch} (kernel path) B={SERVE['batch']} prompt={SERVE['prompt_len']} "
         f"new_tokens={SERVE['new_tokens']}: launches "
         + " ".join(f"{k}={v}" for k, v in launches.items())
         + f"; first run wall_s={wall:.3f} prefill_s={first.prefill_s:.4f} "
         f"({first.prefill_tok_s:.0f} tok/s) decode_s={first.decode_s:.4f} "
         f"({first.decode_tok_s:.1f} tok/s)")
    if launches[kernel] != expect:
        raise AssertionError(f"serve {arch}: {kernel} launched {launches[kernel]} times, "
                             f"expected {expect}")
    others = [k for k, v in launches.items() if v and k != kernel]
    if others:
        raise AssertionError(f"serve {arch}: unexpected kernels launched: {others}")
    toks = first.tokens
    if not (toks.shape == (SERVE["batch"], SERVE["new_tokens"] + 1)
            and ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"serve {arch}: generated tokens out of range / wrong shape")

    prompt = synthetic_token_batch(np.random.default_rng(SERVE["seed"]), SERVE["batch"],
                                   SERVE["prompt_len"], cfg.vocab)["tokens"]
    batch = {"tokens": torch.from_numpy(prompt).to(DEV)}
    got = forward(cfg, params, batch)[0]
    want = forward(ref_cfg, params, batch)[0]
    finite = bool(torch.isfinite(got.float()).all()) and bool(torch.isfinite(want.float()).all())
    err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    same_next = float((got[:, -1].argmax(-1) == want[:, -1].argmax(-1)).float().mean())
    line(f"  prefill logits, kernel path vs ref on the card: rel_err={err:.3e} (limit 4e-2); "
         f"finite={finite}; max|logit|={float(want.float().abs().max()):.3f}; same next "
         f"token {same_next:.2f}; first decoded row: {toks[0, :8].tolist()}")
    del got, want
    if not (finite and err <= 4e-2):
        raise AssertionError(f"serve {arch}: prefill logits off the ref path ({err:.3e})")

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            warm = serve_loop(cfg, device=DEV, params=params, log_every=SERVE["new_tokens"],
                              **SERVE)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    by_line = collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in syncs)
    line(f"  warm run: prefill_s={warm.prefill_s:.4f} ({warm.prefill_tok_s:.0f} tok/s) "
         f"decode_s={warm.decode_s:.4f} ({warm.decode_tok_s:.1f} tok/s, "
         f"{warm.decode_s / SERVE['new_tokens'] * 1e3:.3f} ms/step); same tokens as the first "
         f"run: {bool(np.array_equal(warm.tokens, toks))}; {len(syncs)} synchronizing calls: "
         + ", ".join(f"{k} x{v}" for k, v in by_line.most_common(6)))

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prof_run = serve_loop(cfg, device=DEV, params=params, log_every=SERVE["new_tokens"],
                              **SERVE)
        prof_wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    line(f"  profile (profiled run): wall_s={prof_wall:.3f} prefill_s={prof_run.prefill_s:.4f} "
         f"decode_s={prof_run.decode_s:.4f} device_busy_ms={busy_ms:.2f} device_idle_share="
         f"{1 - busy_ms / 1e3 / prof_wall:.4f} kernel_launches={n_launch} "
         f"(~{n_launch / (SERVE['new_tokens'] + 2):.0f} per step)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        line(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    del params
    torch.cuda.empty_cache()
    return dict(launches=launches, first=first, warm=warm, err=err)


def ptxas_lines(lib: str, kernel: str) -> list[str]:
    """ptxas's report (-Xptxas=-v: registers, static shared memory, spills)
    for every entry of library `lib` whose name contains `kernel`."""
    out, keep = [], False
    for ln in _build.build_info(lib)["log"].splitlines():
        if "Compiling entry" in ln:
            keep = kernel in ln
            name = ln.split("'")[1] if "'" in ln else ln
        elif keep and ("Used" in ln or "spill" in ln):
            out.append(f"{name}: {ln.strip()}")
    return out or [f"{kernel}: no ptxas report in the build log of {lib}"]


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
    global CARD
    CARD = smi.splitlines()[0]
    line(CARD)                           # the card's name and power limit
    line(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
         f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line("tf32: torch.backends.cuda.matmul.allow_tf32=False, "
         "torch.backends.cudnn.allow_tf32=False")

    # ---- 2. kernel build --------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.LIBRARIES)) as pool:
        for fut in [pool.submit(_build.load, lib) for lib in _build.LIBRARIES]:
            fut.result()
    line(f"build: {len(_build.LIBRARIES)} libraries loaded in {time.perf_counter() - t0:.2f}s")
    for lib in _build.LIBRARIES:
        info = _build.build_info(lib)
        line(f"  {lib}: {info['library']} nvcc_s={info['seconds']:.2f} "
             f"flags: {' '.join(_build.nvcc_flags(lib))}")
        for ln in info["log"].splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                line("  ptxas: " + ln.strip())

    cfg_w = WirelessConfig()
    to = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64, device=DEV)

    # ---- 3. K2 --------------------------------------------------------------
    phase_mark(3, t_all)
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
    k2_sass_bound(k2_main[torch.float64]["evals"])

    # ---- 4. K1 --------------------------------------------------------------
    phase_mark(4, t_all)
    n_dev, k_sub = 32768, 4
    rng = np.random.default_rng(21)
    h2_mat = rng.exponential(size=(k_sub, n_dev)) * 3
    beta_mat = np.broadcast_to(rng.integers(5, 60, n_dev).astype(np.float64), h2_mat.shape)
    keep = ~is_infeasible(h2_mat, cfg_w, np.full(h2_mat.shape, cfg_w.e_max_j))
    line(f"K1 batch: {n_dev} devices x {k_sub} sub-channels, "
         f"{int(keep.sum())} Prop-1 feasible pairs")
    check_k1(to(beta_mat[keep]), to(h2_mat[keep]),
             to(np.full(int(keep.sum()), cfg_w.e_max_j)), cfg_w,
             f"{n_dev}x{k_sub}", reps=10, bulk_iters=9)
    big_children = children_of_first_iteration(
        to(beta_mat[keep]), to(h2_mat[keep]), to(np.full(int(keep.sum()), cfg_w.e_max_j)),
        cfg_w)
    sweep_k2(*big_children, cfg_w, f"first children call of the {n_dev}x{k_sub} pairs",
             (1024, 4096, 8192, 16384, 32768, 65536, big_children[0].shape[0]), reps=20)
    main_cfg = SimConfig(rounds=30)
    mb, mh, me, mcfg = main_path_pairs(main_cfg)
    k1_main = check_k1(to(mb), to(mh), to(me), mcfg, "main-path shape (rounds=30)",
                       reps=50)

    # ---- 5. K3 ---------------------------------------------------------------
    phase_mark(5, t_all)
    gen = torch.Generator(DEV).manual_seed(5)
    leaves = [torch.randn((4,) + p.shape, generator=gen, device=DEV).reshape(4, -1)
              for p in get_small_model(main_cfg.dataset).parameters()]
    k3_main = check_k3(leaves, "main-path shape (mnist MLP leaves, one aggregation)",
                       reps=50, plain_reps=3)
    big = torch.randn(16, 1 << 25, generator=gen, device=DEV)
    check_k3([big], "K=16 N=2^25", reps=20, plain_reps=2)
    del big

    # ---- 6. K4 and K5 -----------------------------------------------------------
    phase_mark(6, t_all)
    qwen, rwkv = get_config("qwen2-7b"), get_config("rwkv6-7b")
    fa_lib, wkv_lib = _build.load("flash_attention"), _build.load("rwkv6_wkv")
    for fn, opcodes in _build.sass_opcodes("flash_attention", ("HGMMA", "HMMA")).items():
        if "flash_fwd_bf16_wgmma" in fn:
            line(f"K4 bf16 entry SASS, {fn}: tensor-core instructions "
                 + " ".join(f"{op}={n}" for op, n in opcodes.items()))
    line("K4 bf16 entry: dynamic shared memory "
         + ", ".join(f"D={d}: {fa_lib.flash_attention_bf16_smem_bytes(d)} bytes" for d in (64, 128)))
    for ln in ptxas_lines("flash_attention", "flash_fwd_bf16_wgmma"):
        line("  ptxas: " + ln)
    line(f"K5 wkv6_f32: {wkv_lib.wkv6_threads_per_block(rwkv.rwkv_head_size)} threads per block "
         f"at hs={rwkv.rwkv_head_size}")
    for ln in ptxas_lines("rwkv6_wkv", "wkv6_kernel"):
        line("  ptxas: " + ln)
    b, s = SERVE["batch"], SERVE["prompt_len"]
    attn_shape = (b, s, s, qwen.n_heads, qwen.n_kv_heads, qwen.head_dim, 0)
    k4_main = check_k4(*attn_shape, torch.bfloat16, "main-path shape (qwen2-7b prefill)",
                       reps=20)
    check_k4(*attn_shape, torch.float32, "main-path shape (qwen2-7b prefill)", reps=10)
    for dtype in (torch.bfloat16, torch.float32):
        check_k4(b, 384, s, qwen.n_heads, qwen.n_kv_heads, qwen.head_dim, 128, dtype,
                 "Sq < Sk, window 128", reps=10)
    wkv_shape = (b, rwkv.n_rwkv_heads, rwkv.rwkv_head_size)
    k5_main = check_k5(b, s, *wkv_shape[1:], "main-path prefill shape (rwkv6-7b)", reps=20)
    k5_decode = check_k5(b, 1, *wkv_shape[1:], "main-path decode shape (rwkv6-7b, T=1)",
                         reps=200)

    # ---- 7. the simulation's main paths ---------------------------------------
    phase_mark(7, t_all)
    loop, loop_launches = drive(main_cfg, ("polyblock_fused", "fedavg_agg"))
    step, step_launches = drive(step_cfg, ("polyblock_project", "fedavg_agg"), ra_solver="step")
    scan, scan_launches = drive(main_cfg, ("polyblock_fused", "fedavg_agg"), engine="scan")
    asy, async_launches = drive(dataclasses.replace(main_cfg, aggregation="async"),
                                ("polyblock_fused", "fedavg_agg"), engine="async")
    full, _, _, _ = run_on_card(dataclasses.replace(main_cfg, aggregation="async_full"),
                                engine="async")
    assert_bitwise(full, scan, "async_full vs scan on the card")
    profile_run(main_cfg)
    profile_run(step_cfg, focus=("project_",), ra_solver="step")
    profile_run(main_cfg, engine="scan")
    count_syncs(main_cfg)
    count_syncs(main_cfg, engine="scan")
    count_syncs(dataclasses.replace(main_cfg, aggregation="async"), engine="async")
    # One K3 launch per aggregation: every round with a transmission (loop,
    # scan), every commit event (async: one per round).
    k3 = {name: (c["fedavg_agg"], rounds if name == "async" else int(h.tx_trace.any(1).sum()))
          for name, c, h, rounds in (("loop", loop_launches, loop, main_cfg.rounds),
                                     ("loop_step", step_launches, step, step_cfg.rounds),
                                     ("scan", scan_launches, scan, main_cfg.rounds),
                                     ("async", async_launches, asy, main_cfg.rounds))}
    line("K3 launches per run_simulation: " + " ".join(f"{k}={v[0]}" for k, v in k3.items())
         + " (aggregations: " + " ".join(f"{k}={v[1]}" for k, v in k3.items()) + ")")
    if any(n != want for n, want in k3.values()):
        raise AssertionError("K3 did not launch once per aggregation")
    if any(c["polyblock_fused"] != 1 for c in (loop_launches, scan_launches, async_launches)):
        raise AssertionError("K1 did not launch exactly once per run")
    if step_launches["polyblock_project"] != K2_STEP_LAUNCHES:
        raise AssertionError(f"K2 launched {step_launches['polyblock_project']} times on the "
                             f"step run, expected {K2_STEP_LAUNCHES}")

    # ---- 8. the hierarchy's main paths ----------------------------------------
    phase_mark(8, t_all)
    k1_at = {}                           # K1's bound at the later paths' pairs
    hier_cfg = HierSimConfig(rounds=30, seed=0)
    fused = ("polyblock_fused", "fedavg_agg")
    h_loop, hl_launches = drive_hier(hier_cfg, "loop", fused)
    h_scan, hs_launches = drive_hier(hier_cfg, "scan", fused)
    h_async, ha_launches = drive_hier(
        dataclasses.replace(hier_cfg, aggregation="async", global_aggregation="async"),
        "async", fused)
    h_full = run_on_card(dataclasses.replace(hier_cfg, aggregation="async_full",
                                             global_aggregation="async_full"),
                         hier_sim, engine="async")[0]
    assert_bitwise(h_full["hist"], h_scan["hist"],
                   "hier async_full at both tiers vs scan on the card")
    _, hstep_launches = drive_hier(dataclasses.replace(hier_cfg, rounds=10), "scan",
                                   ("polyblock_project", "fedavg_agg"), ra_solver="step")
    _, h3_launches = drive_hier(dataclasses.replace(hier_cfg, n_cells=3,
                                                    scenario="corr_fading",
                                                    cell_coupling=0.5), "scan", fused)
    profile_run(hier_cfg, focus=("solve_", "agg_leaves"), run=hier_sim, engine="scan")
    count_syncs(hier_cfg, run=hier_sim, engine="scan")
    hb, hh, he, hcfg = hier_pairs(hier_cfg)
    k1_at["hierarchy"] = k1_bound("the hierarchy's pairs (HierSimConfig(rounds=30), both cells)",
                                  to(hb), to(hh), to(he), hcfg)
    line("K3 launches per hierarchy run: " + " ".join(
        f"{k}={v['fedavg_agg']}" for k, v in (("loop", hl_launches), ("scan", hs_launches),
                                              ("async", ha_launches),
                                              ("scan_step", hstep_launches),
                                              ("scan_3_cells", h3_launches))))

    # ---- 9. the sweep harness and the sustained service ----------------------
    phase_mark(9, t_all)
    line(f"sweep and service on {CARD}")
    sweep = sweep_phase()
    service = service_phase()
    sb, sh, se, scfg = service["pairs"]
    k1_at["service_segment"] = k1_bound("the service's first segment (100 events x 16 x 64)",
                                        to(sb), to(sh), to(se), scfg)

    # ---- 10. the serving paths -----------------------------------------------
    phase_mark(10, t_all)
    n_new = SERVE["new_tokens"]
    qwen_serve = serve_phase("qwen2-7b", "flash_attention", qwen.n_layers)
    rwkv_serve = serve_phase("rwkv6-7b", "rwkv6_wkv", rwkv.n_layers * (1 + n_new + 1))
    line(f"K5 per launch on the card: prefill {k5_main['ms']:.4f} ms, decode "
         f"{k5_decode['ms']:.4f} ms")

    # ---- 11. kernel list ----------------------------------------------------
    phase_mark(11, t_all)
    kernels = []
    hier_launches = {"polyblock_fused": hs_launches["polyblock_fused"],
                     "polyblock_project": hstep_launches["polyblock_project"],
                     "fedavg_agg": hs_launches["fedavg_agg"]}
    for name, src, replaces, launches, res in (
            ("polyblock_fused", "src/repro_torch/csrc/polyblock.cu",
             "src/repro/kernels/polyblock_fused/kernel.py:61",
             loop_launches["polyblock_fused"], dict(k1_main[torch.float64], library_ms=None)),
            ("polyblock_project", "src/repro_torch/csrc/polyblock.cu",
             "src/repro/kernels/polyblock_project/kernel.py:39",
             step_launches["polyblock_project"], dict(k2_main[torch.float64], library_ms=None)),
            ("fedavg_agg", "src/repro_torch/csrc/fedavg_agg.cu",
             "src/repro/kernels/fedavg_agg/kernel.py:22",
             scan_launches["fedavg_agg"], k3_main),
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:25",
             qwen_serve["launches"]["flash_attention"], k4_main),
            ("rwkv6_wkv", "src/repro_torch/csrc/rwkv6_wkv.cu",
             "src/repro/kernels/rwkv6_wkv/kernel.py:26",
             rwkv_serve["launches"]["rwkv6_wkv"], k5_main)):
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=launches, max_abs_err=res["max_abs_err"],
                            ms=res["ms"], plain_ms=res["plain_ms"],
                            bound_ms=res["bound_ms"], bound_by=res["bound_by"],
                            library_ms=res["library_ms"]))
        if "lanes" in res:
            kernels[-1]["lanes"] = res["lanes"]
        if name == "polyblock_fused":
            kernels[-1]["at"] = k1_at
        if name in hier_launches:
            kernels[-1]["hier_launches"] = hier_launches[name]
            kernels[-1]["sweep_launches"] = sweep["launches"][name]
            kernels[-1]["service_launches"] = (service["step_launches"][name]
                                               if name == "polyblock_project"
                                               else service["launches"][name])
    line(f"total wall_s={time.perf_counter() - t_all:.1f}")
    line(json.dumps({"kernels": kernels}))
    line(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
