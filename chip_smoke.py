"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/csrc/`, holds each
against its plain PyTorch version on the card, drives the paper simulation
(`run_simulation`, host-loop engine) through them, and checks its traces
against the same run on the CPU.  Phases, in order:

  1. card identity (nvidia-smi name and power limit, torch and CUDA versions);
  2. kernel build (nvcc, plain C interface loaded with ctypes);
  3. K2, the polyblock projection, against its plain version, float64 and
     float32, at 2 x 131072 vertices and at the main path's shape;
  4. K1, the whole Algorithm-1 solve, against its plain version, float64
     and float32, at 32768 devices x 4 sub-channels and at the main path's
     shape;
  5. the main path: run_simulation(SimConfig(rounds=30)) — mnist MLP at
     full width, N=20, K=4, Table-I settings, Γ through K1 — then
     ra_solver="step" for 10 rounds through K2; launch counters, loss, and
     tx/age traces equal to the device="cpu" run;
  6. the kernel list as one JSON line.

Any failure raises; the last line is the device JSON only when every phase
passed.  Exits non-zero without a CUDA device or without the repository's
`src/` beside this file.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA device")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import WirelessConfig, is_infeasible, total_energy  # noqa: E402
from repro_torch.fl import SimConfig, run_simulation  # noqa: E402
from repro_torch.fl.sim import _prepare  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
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


def time_ms(fn, reps: int) -> float:
    """Mean device time of one call, by CUDA events around `reps` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
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
# the main path
# ---------------------------------------------------------------------------

def drive(cfg: SimConfig, ra_solver: str, counter) -> tuple:
    polyblock_solve_fused.launches = 0
    polyblock_project.launches = 0
    t0 = time.perf_counter()
    hist = run_simulation(cfg, ra_solver=ra_solver, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter.launches
    other = (polyblock_project if counter is polyblock_solve_fused
             else polyblock_solve_fused).launches
    t0 = time.perf_counter()
    again = run_simulation(cfg, ra_solver=ra_solver, device=DEV)
    torch.cuda.synchronize()
    warm_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = run_simulation(cfg, ra_solver=ra_solver, device="cpu")
    cpu_wall = time.perf_counter() - t0
    name = "polyblock_solve_fused (K1)" if counter is polyblock_solve_fused \
        else "polyblock_project (K2)"
    line(f"main path ra_solver={ra_solver} rounds={cfg.rounds}: {name} launches={launches} "
         f"(other kernel {other}); gpu wall_s first run={wall:.3f} (plan_wall_s="
         f"{hist.plan_wall_s:.4f}), second run={warm_wall:.3f} (plan_wall_s="
         f"{again.plan_wall_s:.4f}); cpu wall_s={cpu_wall:.3f} (plan_wall_s="
         f"{ref.plan_wall_s:.4f})")
    line("  loss: " + " ".join(f"{x:.4f}" for x in hist.global_loss))
    line("  acc:  " + " ".join(f"{x:.3f}" for x in hist.accuracy))
    tx_same = np.array_equal(hist.tx_trace, ref.tx_trace)
    age_same = np.array_equal(hist.age_trace, ref.age_trace)
    lat_rel = float(np.max(np.abs(hist.latency_all - ref.latency_all)
                           / np.maximum(ref.latency_all, 1e-300)))
    line(f"  tx trace == cpu: {tx_same}; age trace == cpu: {age_same}; "
         f"latency max_rel vs cpu: {lat_rel:.3e}; transmissions: {int(hist.tx_trace.sum())}")
    if launches < 1:
        raise AssertionError(f"{name} was not launched on the main path")
    if not (np.all(np.isfinite(hist.global_loss)) and hist.global_loss.shape == (cfg.rounds,)):
        raise AssertionError("losses are not finite / not one per round")
    if not hist.global_loss[-1] < hist.global_loss[0]:
        raise AssertionError("training did not lower the loss")
    if not np.array_equal(again.tx_trace, hist.tx_trace):
        raise AssertionError("two runs of the same seed on the card differ in tx")
    if not (tx_same and age_same):
        raise AssertionError("tx/age traces differ from the CPU run")
    return launches, wall


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
    _build.load_polyblock()
    info = _build.build_info()
    line(f"build: {info['library']} nvcc_s={info['seconds']:.2f} "
         f"(load total {time.perf_counter() - t0:.2f}s) flags: {' '.join(_build.NVCC_FLAGS)}")
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

    # ---- 5. the main path -----------------------------------------------------
    k1_launches, _ = drive(main_cfg, "fused", polyblock_solve_fused)
    k2_launches, _ = drive(step_cfg, "step", polyblock_project)

    # ---- 6. kernel list -----------------------------------------------------
    src = "src/repro_torch/csrc/polyblock.cu"
    kernels = []
    for name, replaces, launches, res in (
            ("polyblock_fused", "src/repro/kernels/polyblock_fused/kernel.py:61",
             k1_launches, k1_main[torch.float64]),
            ("polyblock_project", "src/repro/kernels/polyblock_project/kernel.py:39",
             k2_launches, k2_main[torch.float64])):
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=launches, max_abs_err=res["max_abs_err"],
                            ms=res["ms"], plain_ms=res["plain_ms"],
                            bound_ms=res["bound_ms"], bound_by=res["bound_by"],
                            library_ms=None))
    line(f"total wall_s={time.perf_counter() - t_all:.1f}")
    line(json.dumps({"kernels": kernels}))
    line(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
