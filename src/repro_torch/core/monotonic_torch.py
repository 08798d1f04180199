"""Batched Algorithm 1 on the card: the counterpart of the JAX package's
`core/monotonic_jax.py`.

Two drivers, both drop-ins for the host `monotonic.solve_pairs` (same
arguments, host numpy `RAResult`):

  solve_pairs_fused -- the whole polyblock solve of every feasible pair in
                       one launch of kernel K1 (`kernels.polyblock_fused`);
                       on the CPU, its plain torch version.  The JAX
                       package's staged jit driver (bucket compaction, lazy
                       store growth, `shard_map`) exists to feed XLA fixed
                       shapes; the kernel replaces it here, as the Pallas
                       `polyblock_fused` kernel replaces it on the TPU.
  solve_pairs_step  -- the counterpart of `solve_pairs_jit`: the
                       selection / children loop in torch, one projection
                       call per iteration for the children of the still-
                       active pairs, through kernel K2 (backend "cuda") or
                       the plain bisection (backend "bisect").

Proposition-1 feasibility is decided on the host in float64 before either
driver runs, and energies of the solved points are evaluated there too,
exactly as the JAX drivers do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.polyblock_fused.ops import polyblock_solve_fused
from ..kernels.polyblock_project.ops import polyblock_project, project_bisect
from .feasibility import is_infeasible
from .monotonic import RAResult
from .wireless import WirelessConfig, total_energy, total_time

__all__ = ["solve_pairs_fused", "solve_pairs_step"]


def _flatten(beta, h2, cfg: WirelessConfig, e_max):
    h2 = np.asarray(h2, dtype=np.float64)
    e_max = cfg.e_max_j if e_max is None else e_max
    beta_f = np.broadcast_to(np.asarray(beta, np.float64), h2.shape).reshape(-1)
    e_f = np.broadcast_to(np.asarray(e_max, np.float64), h2.shape).reshape(-1)
    return h2.shape, beta_f, h2.reshape(-1), e_f


def _result(shape, feas, beta_f, h2f, cfg, work, tau_w, p_w, time_w, it_w):
    n = h2f.shape[0]
    tau = np.full(n, np.nan)
    p = np.full(n, np.nan)
    time_s = np.full(n, np.inf)
    energy = np.full(n, np.nan)
    iters = np.zeros(n, dtype=np.int64)
    if work.size:
        tau[work] = tau_w
        p[work] = p_w
        time_s[work] = time_w
        energy[work] = total_energy(tau[work], p[work], beta_f[work], h2f[work], cfg)
        iters[work] = it_w
    return RAResult(tau=tau.reshape(shape), p=p.reshape(shape),
                    time_s=time_s.reshape(shape), energy_j=energy.reshape(shape),
                    feasible=feas.reshape(shape), iterations=iters.reshape(shape))


def _host(x: torch.Tensor, dtype=np.float64) -> np.ndarray:
    return x.cpu().numpy().astype(dtype)


def solve_pairs_fused(beta, h2, cfg: WirelessConfig, e_max=None, *,
                      eps: float | None = None, max_iter: int = 64,
                      n_bisect: int = 60, device=None) -> RAResult:
    """Algorithm 1 over pairs of any shape, all of it in kernel K1, in
    float64 (the type of the JAX package's CPU solvers, which it tracks
    pair for pair).  beta and e_max broadcast against h2."""
    device = resolve_device(device)
    eps = 0.01 if eps is None else float(eps)
    shape, beta_f, h2f, e_f = _flatten(beta, h2, cfg, e_max)
    feas = ~is_infeasible(h2f, cfg, e_f)
    work = np.where(feas)[0]
    out = (None,) * 4
    if work.size:
        on_dev = lambda x: torch.as_tensor(x[work], device=device)
        k_tau, k_p, k_time, k_it = polyblock_solve_fused(
            on_dev(beta_f), on_dev(h2f), on_dev(e_f), cfg, eps=eps,
            max_iter=max_iter, n_bisect=n_bisect)
        out = (_host(k_tau), _host(k_p), _host(k_time), _host(k_it, np.int64))
    return _result(shape, feas, beta_f, h2f, cfg, work, *out)


def solve_pairs_step(beta, h2, cfg: WirelessConfig, e_max=None, *,
                     eps: float | None = None, max_iter: int = 64,
                     backend: str = "cuda", n_bisect: int = 60,
                     device=None) -> RAResult:
    """Algorithm 1 over pairs of any shape, one iteration at a time, in
    float64.

    backend: "cuda" projects through kernel K2 (its wrapper runs the plain
    bisection for CPU tensors), "bisect" through the plain torch bisection
    on any device.
    """
    if backend == "cuda":
        project = polyblock_project
    elif backend == "bisect":
        project = project_bisect
    else:
        raise ValueError(f"unknown backend: {backend!r} (use 'cuda' or 'bisect')")
    device = resolve_device(device)
    eps = 0.01 if eps is None else float(eps)
    shape, beta_f, h2f, e_f = _flatten(beta, h2, cfg, e_max)
    feas = ~is_infeasible(h2f, cfg, e_f)
    work = np.where(feas)[0]
    if not work.size:
        return _result(shape, feas, beta_f, h2f, cfg, work, *(None,) * 4)

    on_dev = lambda x: torch.as_tensor(x[work], device=device)
    beta_t, h2_t, e_t = on_dev(beta_f), on_dev(h2f), on_dev(e_f)
    b, m = work.size, max_iter + 1          # step t writes slot <= t + 1
    rows = torch.arange(b, device=device)

    v0 = torch.ones(b, 2, dtype=torch.float64, device=device)
    pj0 = project(v0, beta_t, h2_t, e_t, cfg, n_bisect=n_bisect)
    f0 = -total_time(pj0[:, 0], pj0[:, 1], beta_t, h2_t, cfg)
    verts = torch.zeros(b, m, 2, dtype=torch.float64, device=device)
    vproj = torch.zeros(b, m, 2, dtype=torch.float64, device=device)
    vfval = torch.full((b, m), -torch.inf, dtype=torch.float64, device=device)
    valid = torch.zeros(b, m, dtype=torch.bool, device=device)
    verts[:, 0], vproj[:, 0], vfval[:, 0], valid[:, 0] = v0, pj0, f0, True

    active = torch.ones(b, dtype=torch.bool, device=device)
    prev_best = torch.full((b,), torch.inf, dtype=torch.float64, device=device)
    best_f, best_proj = f0, pj0
    iters = torch.zeros(b, dtype=torch.int64, device=device)
    nvalid = torch.ones(b, dtype=torch.int64, device=device)

    for _ in range(max_iter):
        # Selection half-step (paper steps 9-10), over every pair.
        fv = torch.where(valid, vfval, -torch.inf)
        idx = torch.argmax(fv, dim=1)                     # first max
        fbest = fv[rows, idx]
        improved = fbest > best_f
        best_f = torch.where(improved, fbest, best_f)
        best_proj = torch.where(improved[:, None], vproj[rows, idx], best_proj)
        done = (fbest - prev_best).abs() <= eps            # eq. (26)
        prev_best = fbest
        active = active & ~done
        iters = iters + active.to(torch.int64)
        a = torch.nonzero(active)[:, 0]
        if a.numel() == 0:
            break

        # Children half-step (paper steps 11-13) for the active pairs only.
        ia = idx[a]
        v, phi = verts[a, ia], vproj[a, ia]
        child1 = torch.stack([phi[:, 0], v[:, 1]], dim=-1)  # eq. (23)
        child2 = torch.stack([v[:, 0], phi[:, 1]], dim=-1)
        beta2, h22, e2 = (torch.cat([x[a], x[a]]) for x in (beta_t, h2_t, e_t))
        pj = project(torch.cat([child1, child2]), beta2, h22, e2, cfg,
                     n_bisect=n_bisect)
        fj = -total_time(pj[:, 0], pj[:, 1], beta2, h22, cfg)
        na = a.numel()
        slot2 = nvalid[a]                                  # eq. (24)
        verts[a, ia], vproj[a, ia], vfval[a, ia] = child1, pj[:na], fj[:na]
        verts[a, slot2], vproj[a, slot2], vfval[a, slot2] = child2, pj[na:], fj[na:]
        valid[a, slot2] = True
        nvalid[a] += 1

    return _result(shape, feas, beta_f, h2f, cfg, work, _host(best_proj[:, 0]),
                   _host(best_proj[:, 1]), _host(-best_f), _host(iters, np.int64))
