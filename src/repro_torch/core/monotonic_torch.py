"""Batched Algorithm 1 on the card: the counterpart of the JAX package's
`core/monotonic_jax.py`.

Two drivers, both drop-ins for the host `monotonic.solve_pairs` (same
arguments, host numpy `RAResult`), and `precompute_gamma`, the
whole-horizon (rounds, K, N) solve through either:

  solve_pairs_step  -- the counterpart of `solve_pairs_jit`: the
                       selection / children loop in torch, one projection
                       call per iteration for the children of the still-
                       active pairs, by the projection backend named:
                       kernel K2 (None, "cuda", alias "pallas"), the plain
                       bisection ("bisect", alias "jnp"), the log-space
                       Newton ("newton") or the float32-bulk / float64-
                       polish Newton ("mixed", warm-started from the parent
                       vertex as the JAX package's `_children_impl` does);
  solve_pairs_fused -- the counterpart of the JAX package's staged
                       `solve_pairs_fused`.  With backend None, "cuda" or
                       "pallas", the whole polyblock solve of every
                       feasible pair in one launch of kernel K1
                       (`kernels.polyblock_fused`; on the CPU, its plain
                       torch version), as the Pallas `polyblock_fused`
                       kernel solves it on the TPU.  With any other
                       backend, the step loop with that projection: the
                       JAX staged driver's contract is that it is bit for
                       bit `solve_pairs_jit` with the same backend (its
                       bucket compaction, lazy store growth and stage
                       boundaries only feed XLA fixed shapes), so the step
                       loop is that driver here.

The defaults differ from the JAX package's off the TPU (fused "mixed",
step "newton"): None means the kernels, K1 fused and K2 step, on every
device, whose plain versions run on the CPU.

Proposition-1 feasibility is decided on the host in float64 before either
driver runs, and energies of the solved points are evaluated there too,
exactly as the JAX drivers do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.polyblock_fused.ops import polyblock_solve_fused
from ..kernels.polyblock_project.ops import project as project_by
from ..kernels.polyblock_project.ops import project_newton_mixed
from ..launch.mesh import local_devices, map_shards, split_padded, use_shards
from .feasibility import is_infeasible
from .monotonic import RAResult
from .wireless import WirelessConfig, total_energy, total_time

__all__ = ["solve_pairs_fused", "solve_pairs_step", "precompute_gamma",
           "RA_BACKENDS", "check_ra_backend"]

# The projection backends both drivers take: None and "cuda" (alias
# "pallas") are the kernels, the rest the JAX package's plain projections.
RA_BACKENDS = (None, "cuda", "pallas", "bisect", "jnp", "newton", "mixed")
_KERNEL_BACKENDS = (None, "cuda", "pallas")


def check_ra_backend(backend) -> None:
    """Raise ValueError unless `backend` names a projection backend."""
    if backend not in RA_BACKENDS:
        raise ValueError(f"unknown backend: {backend!r} (one of {RA_BACKENDS})")


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


def _fused_rows(beta_w, h2_w, e_w, cfg, device, *, eps, max_iter, n_bisect, backend):
    """K1 on feasible rows: one launch, (tau, p, T, iterations) on the host."""
    on_dev = lambda x: torch.as_tensor(x, device=device)
    k_tau, k_p, k_time, k_it = polyblock_solve_fused(
        on_dev(beta_w), on_dev(h2_w), on_dev(e_w), cfg, eps=eps, max_iter=max_iter,
        n_bisect=n_bisect)
    return _host(k_tau), _host(k_p), _host(k_time), _host(k_it, np.int64)


def _rows_sharded(rows_fn, beta_w, h2_w, e_w, cfg, devices, opts):
    """`rows_fn` over the rows split into one block per device (the last
    padded by repeating row 0, dropped after), each block on its device;
    the blocks' results joined in row order.  Each pair is solved alone
    whatever its neighbours, so the join is bitwise the unsharded solve."""
    parts = map_shards(lambda idx, dev: rows_fn(beta_w[idx], h2_w[idx], e_w[idx], cfg, dev,
                                                **opts),
                       split_padded(h2_w.shape[0], len(devices)), devices)
    n = h2_w.shape[0]
    return tuple(np.concatenate([part[f] for part in parts])[:n] for f in range(4))


def _solve(rows_fn, beta, h2, cfg: WirelessConfig, e_max, *, eps, max_iter, backend,
           n_bisect, device, shard) -> RAResult:
    """Proposition-1 feasibility on the host, then `rows_fn` on the feasible
    rows: on `device`, or split over the local devices when `shard` allows
    (`_rows_sharded`)."""
    check_ra_backend(backend)
    device = resolve_device(device)
    eps = 0.01 if eps is None else float(eps)
    shape, beta_f, h2f, e_f = _flatten(beta, h2, cfg, e_max)
    feas = ~is_infeasible(h2f, cfg, e_f)
    work = np.where(feas)[0]
    if not work.size:
        return _result(shape, feas, beta_f, h2f, cfg, work, *(None,) * 4)
    opts = dict(eps=eps, max_iter=max_iter, n_bisect=n_bisect, backend=backend)
    devices = local_devices(device)
    if use_shards(shard, devices):
        out = _rows_sharded(rows_fn, beta_f[work], h2f[work], e_f[work], cfg, devices, opts)
    else:
        out = rows_fn(beta_f[work], h2f[work], e_f[work], cfg, device, **opts)
    return _result(shape, feas, beta_f, h2f, cfg, work, *out)


def solve_pairs_fused(beta, h2, cfg: WirelessConfig, e_max=None, *,
                      eps: float | None = None, max_iter: int = 64,
                      backend: str | None = None, n_bisect: int = 60,
                      device=None, shard: bool | None = None) -> RAResult:
    """Algorithm 1 over pairs of any shape, in float64 (the type of the
    JAX package's CPU solvers, which it tracks pair for pair).  beta and
    e_max broadcast against h2.

    backend: None, "cuda" or "pallas" solve all of it in kernel K1 (its
    plain version on the CPU); "bisect" (alias "jnp"), "newton" or "mixed"
    run `solve_pairs_step`'s loop with that projection, bit for bit, as
    the JAX package's staged driver runs `solve_pairs_jit`'s trajectory.

    shard: the feasible pairs' rows split over `launch.mesh.local_devices`
    (pad-and-drop), one block per device, solved at once (one K1 launch
    per block) and joined in row order; None shards when more than one
    device is visible, True on one device is the unsharded path, False
    never shards.  Every field is bitwise the unsharded solve."""
    rows_fn = _fused_rows if backend in _KERNEL_BACKENDS else _step_rows
    return _solve(rows_fn, beta, h2, cfg, e_max, eps=eps, max_iter=max_iter,
                  backend=backend, n_bisect=n_bisect, device=device, shard=shard)


def solve_pairs_step(beta, h2, cfg: WirelessConfig, e_max=None, *,
                     eps: float | None = None, max_iter: int = 64,
                     backend: str | None = None, n_bisect: int = 60,
                     device=None) -> RAResult:
    """Algorithm 1 over pairs of any shape, one iteration at a time, in
    float64.

    backend: None, "cuda" or "pallas" project through kernel K2 (its
    wrapper runs the plain bisection for CPU tensors); "bisect" (alias
    "jnp") through the plain torch bisection, "newton" through
    `project_newton` and "mixed" through `project_newton_mixed` on any
    device.  "mixed" projects (1, 1) cold with 4 float32 steps and each
    child with 2 float32 steps and 1 float64 step from its parent's zeta,
    as the JAX package's `_init_state` / `_children_impl` do.  n_bisect is
    the halving count of the bisection backends.
    """
    return _solve(_step_rows, beta, h2, cfg, e_max, eps=eps, max_iter=max_iter,
                  backend=backend, n_bisect=n_bisect, device=device, shard=False)


def _step_rows(beta_w, h2_w, e_w, cfg, device, *, eps, max_iter, n_bisect, backend):
    """The step loop on feasible rows: (tau, p, T, iterations) on the host."""

    def project(v, b, h, e, hint=None):
        """The backend's projection; `hint` is the parents' zeta ("mixed"
        children), None for the cold projection of (1, 1)."""
        if backend != "mixed":
            return project_by(v, b, h, e, cfg, backend=backend or "cuda",
                              n_bisect=n_bisect)
        if hint is None:
            return project_newton_mixed(v, b, h, e, cfg, n_f32=4)
        return project_newton_mixed(v, b, h, e, cfg, n_f32=2, n_f64=1, x0_hint=hint)

    on_dev = lambda x: torch.as_tensor(x, device=device)
    beta_t, h2_t, e_t = on_dev(beta_w), on_dev(h2_w), on_dev(e_w)
    b, m = h2_w.shape[0], max_iter + 1          # step t writes slot <= t + 1
    rows = torch.arange(b, device=device)

    v0 = torch.ones(b, 2, dtype=torch.float64, device=device)
    pj0 = project(v0, beta_t, h2_t, e_t)
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
        hint = None
        if backend == "mixed":  # the parent's zeta bounds both children's roots below
            zeta = phi[:, 0] / torch.clamp_min(v[:, 0], 1e-300)
            hint = torch.cat([zeta, zeta])
        pj = project(torch.cat([child1, child2]), beta2, h22, e2, hint)
        fj = -total_time(pj[:, 0], pj[:, 1], beta2, h22, cfg)
        na = a.numel()
        slot2 = nvalid[a]                                  # eq. (24)
        verts[a, ia], vproj[a, ia], vfval[a, ia] = child1, pj[:na], fj[:na]
        verts[a, slot2], vproj[a, slot2], vfval[a, slot2] = child2, pj[na:], fj[na:]
        valid[a, slot2] = True
        nvalid[a] += 1

    return (_host(best_proj[:, 0]), _host(best_proj[:, 1]), _host(-best_f),
            _host(iters, np.int64))


def precompute_gamma(beta, h2_all, cfg: WirelessConfig, e_max=None, *,
                     solver: str = "fused", device=None, **kw) -> RAResult:
    """Whole-horizon Γ: Algorithm 1 for every (round, sub-channel, device)
    pair in one solve.  h2_all is (rounds, K, N), beta broadcasts as (N,);
    the RAResult's fields are (rounds, K, N) — Γ is `time_s`, the
    Proposition-1 mask `feasible`.  solver: "fused" (`solve_pairs_fused`)
    or "step" (`solve_pairs_step`); the rest (eps, max_iter, backend,
    n_bisect) goes to the solver."""
    if solver not in ("fused", "step"):
        raise ValueError(f"unknown solver: {solver!r} (use 'fused' or 'step')")
    solve = solve_pairs_fused if solver == "fused" else solve_pairs_step
    return solve(np.asarray(beta, np.float64)[None, None, :],
                 np.asarray(h2_all, np.float64), cfg, e_max, device=device, **kw)
