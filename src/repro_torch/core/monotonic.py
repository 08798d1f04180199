"""Algorithm 1: polyblock outer approximation for the per-pair resource
allocation problem (paper Sec. IV-A, eqs. 19-29).

For every (device n, sub-channel k) combination we solve

    min  T^cp(tau) + T^cm(p)
    s.t. E^cp(tau) + E^cm(p) <= E_n^max,   tau, p in [0, 1]

which, in canonical monotonic form (eq. 20), is  max f(z) over z in G with

    f(z) = -mu*beta/(tau*C) - D / (B log2(1 + p |h|^2))            (eq. 21)
    g(z) =  kappa0*mu*beta*(tau*C)^2
            + p*P_t*D / (B log2(1 + p |h|^2)) - E^max               (eq. 22)

f is increasing and g is increasing (Proposition 2), so the optimum lies on
the upper boundary of G = {z : g(z) <= 0} and the polyblock algorithm
converges to it from the outside.

Deviations from the paper (documented in DESIGN.md §5):
  * the projection root g(zeta * v) = 0 (eq. 29) is solved by *bisection*
    (g is strictly increasing in zeta), not MATLAB fsolve;
  * the whole algorithm is vectorized across all (K x N) pairs at once --
    each pair keeps its own vertex set in a preallocated array and pairs
    retire independently when their eq. (26) tolerance is met.

This module is the host-side (NumPy) reference implementation, a copy of
the JAX package's `core/monotonic.py` held bit-identical to it.  The
batched device drivers — the step driver over the projection kernel and
the whole-solve kernel — live in `core.monotonic_torch` and
`kernels.polyblock_*`.
"""
from __future__ import annotations

import dataclasses
import numpy as np

from ..kernels.polyblock_project.ref import project_ref
from .feasibility import is_infeasible
from .wireless import WirelessConfig, total_energy, total_time

__all__ = ["RAResult", "solve_pairs", "fixed_ra", "f_obj", "g_con"]

_TINY = 1e-12


@dataclasses.dataclass(frozen=True)
class RAResult:
    """Optimal resource allocation for a batch of (device, channel) pairs."""

    tau: np.ndarray       # computational-capacity fraction tau*
    p: np.ndarray         # power fraction p*
    time_s: np.ndarray    # T(tau*, p*), +inf where infeasible
    energy_j: np.ndarray  # E(tau*, p*)
    feasible: np.ndarray  # Proposition-1 mask
    iterations: np.ndarray  # polyblock iterations consumed per pair


def f_obj(tau, p, beta, h2, cfg: WirelessConfig):
    """Eq. (21): negative total time (to be maximized)."""
    return -total_time(tau, p, beta, h2, cfg)


def g_con(tau, p, beta, h2, cfg: WirelessConfig, e_max):
    """Eq. (22): total energy minus budget (feasible iff <= 0)."""
    return total_energy(tau, p, beta, h2, cfg) - e_max


def _project(v, beta, h2, e_max, cfg: WirelessConfig, n_bisect: int = 60):
    """Projection phi(v) = zeta*v onto the boundary of G (eqs. 27-29).

    Vectorized bisection on zeta in (0, 1]: g(zeta*v) is strictly increasing
    in zeta, g -> (Prop-1 threshold - E^max) < 0 as zeta -> 0 for feasible
    pairs, so a root exists whenever g(v) > 0; otherwise zeta = 1 (the vertex
    itself is feasible -- paper's theta=1 corner case).

    Canonical implementation shared with the device backends:
    `kernels.polyblock_project` (ref.py / ops.py / kernel.py).
    """
    return project_ref(v, beta, h2, e_max, cfg, n_bisect=n_bisect)


def solve_pairs(
    beta,
    h2,
    cfg: WirelessConfig,
    e_max=None,
    *,
    eps: float | None = None,
    max_iter: int = 64,
) -> RAResult:
    """Run Algorithm 1 for a batch of pairs.

    Args:
      beta: samples per device, broadcastable to h2's shape.
      h2:   normalized channel gains |h_{k,n}|^2, any shape (typically (K, N)).
      e_max: per-pair energy budgets (default cfg.e_max_j).
      eps:  eq. (26) stopping tolerance on |f| change (default 0.01 = Table I).
    """
    h2 = np.asarray(h2, dtype=np.float64)
    shape = h2.shape
    beta = np.broadcast_to(np.asarray(beta, np.float64), shape).reshape(-1).copy()
    h2f = h2.reshape(-1).copy()
    e_max = cfg.e_max_j if e_max is None else e_max
    e_maxf = np.broadcast_to(np.asarray(e_max, np.float64), shape).reshape(-1).copy()
    eps = 0.01 if eps is None else eps

    n = h2f.shape[0]
    feas = ~is_infeasible(h2f, cfg, e_maxf)

    # Vertex store: one row per pair, up to max_iter+1 vertices each.
    m = max_iter + 2
    verts = np.zeros((n, m, 2))
    vproj = np.zeros((n, m, 2))
    vfval = np.full((n, m), -np.inf)
    valid = np.zeros((n, m), dtype=bool)

    verts[:, 0] = 1.0
    vproj[:, 0] = _project(verts[:, 0], beta, h2f, e_maxf, cfg)
    vfval[:, 0] = f_obj(vproj[:, 0, 0], vproj[:, 0, 1], beta, h2f, cfg)
    valid[:, 0] = True

    active = feas.copy()
    prev_best = np.full(n, np.inf)
    best_proj = vproj[:, 0].copy()
    best_f = vfval[:, 0].copy()
    iters = np.zeros(n, dtype=np.int64)

    for t in range(max_iter):
        if not active.any():
            break
        fv = np.where(valid, vfval, -np.inf)
        idx = np.argmax(fv, axis=1)                    # paper step 9
        rows = np.arange(n)
        fbest = fv[rows, idx]

        improved = fbest > best_f
        best_f = np.where(improved, fbest, best_f)
        best_proj = np.where(improved[:, None], vproj[rows, idx], best_proj)

        done = np.abs(fbest - prev_best) <= eps        # eq. (26)
        prev_best = fbest
        newly_done = active & done
        active &= ~done
        iters[active] += 1
        if not active.any():
            break

        a = np.where(active)[0]
        v = verts[a, idx[a]]                           # (na, 2)
        phi = vproj[a, idx[a]]
        # Children (eq. 23): v - (v_i - phi_i) e_i.
        child1 = v.copy(); child1[:, 0] = phi[:, 0]
        child2 = v.copy(); child2[:, 1] = phi[:, 1]
        # Replace the split vertex with child1, append child2 (eq. 24).
        slot_new = t + 1
        for child, slot in ((child1, idx[a]), (child2, np.full(len(a), slot_new))):
            pj = _project(child, beta[a], h2f[a], e_maxf[a], cfg)
            fj = f_obj(pj[:, 0], pj[:, 1], beta[a], h2f[a], cfg)
            verts[a, slot] = child
            vproj[a, slot] = pj
            vfval[a, slot] = fj
            valid[a, slot] = True
        del newly_done

    tau = np.where(feas, best_proj[:, 0], np.nan)
    p = np.where(feas, best_proj[:, 1], np.nan)
    time_s = np.where(feas, -best_f, np.inf)
    energy = np.where(
        feas, total_energy(best_proj[:, 0], best_proj[:, 1], beta, h2f, cfg), np.nan
    )
    return RAResult(
        tau=tau.reshape(shape),
        p=p.reshape(shape),
        time_s=time_s.reshape(shape),
        energy_j=energy.reshape(shape),
        feasible=feas.reshape(shape),
        iterations=iters.reshape(shape),
    )


def fixed_ra(beta, h2, cfg: WirelessConfig, e_max=None, *, tau0=0.5, p0=0.5) -> RAResult:
    """FIX-RA baseline: tau = p = 0.5 (Sec. VI); infeasible where the budget
    is violated at the fixed point."""
    h2 = np.asarray(h2, dtype=np.float64)
    e_max = cfg.e_max_j if e_max is None else e_max
    beta_b = np.broadcast_to(np.asarray(beta, np.float64), h2.shape)
    e_b = np.broadcast_to(np.asarray(e_max, np.float64), h2.shape)
    tau = np.full(h2.shape, tau0)
    p = np.full(h2.shape, p0)
    energy = total_energy(tau, p, beta_b, h2, cfg)
    feas = energy <= e_b
    time_s = np.where(feas, total_time(tau, p, beta_b, h2, cfg), np.inf)
    return RAResult(
        tau=np.where(feas, tau, np.nan),
        p=np.where(feas, p, np.nan),
        time_s=time_s,
        energy_j=np.where(feas, energy, np.nan),
        feasible=feas,
        iterations=np.zeros(h2.shape, dtype=np.int64),
    )
