"""K1: all of Algorithm 1 in one kernel — plain torch and CUDA.

For each Proposition-1 feasible (beta, |h|^2, E^max) pair: the polyblock
outer approximation of the JAX package's Pallas kernel
`kernels/polyblock_fused/kernel.py::_solve_kernel` — a vertex store of
max_iter + 1 slots, first-max selection (paper steps 9-10), eq.-26
retirement at eps, eq.-23 children with two bisection projections, eq.-24
store writes masked by the active set.  Returns (tau*, p*, T*, iterations).

  polyblock_solve_plain -- the plain torch version: the Pallas body
                           vectorised over pairs, (m, n) store tensors and a
                           `while active.any()` loop;
  polyblock_solve_fused -- the wrapper of the CUDA kernels (csrc/polyblock.cu):
                           `solve_coop_kernel`, 2L lanes of a warp per pair
                           (L = 4, 8 or 16 lanes per child, chosen from the
                           pair count by `coop_lanes`), or `solve_kernel`,
                           one thread per pair (lanes=1, the reference
                           schedule);
  first_max_lanes       -- a plain emulation of the cooperative kernel's
                           selection (strided scan, butterfly), for tests.

Callers pass feasible pairs only (infeasibility is resolved before, as in
`core.monotonic_torch`).
"""
from __future__ import annotations

import torch

from ...core.wireless import WirelessConfig, total_time
from .._build import check_launch, count_launches, load_polyblock
from ..polyblock_project.ops import LANES, project_bisect

__all__ = ["polyblock_solve_plain", "polyblock_solve_fused", "coop_lanes", "first_max_lanes",
           "LANES"]

_DTYPES = (torch.float64, torch.float32)
# LANES: the lanes per child the C entry takes, 1 `solve_kernel` (one
# thread per pair), 4, 8 and 16 `solve_coop_kernel`.
# Pair counts up to this take 16 lanes per child, larger ones 4: about the
# warps the card holds at once (132 SMs x 24-28), so up to it every pair
# has a warp of its own from the start (the same-run sweep in PERF.md).
WIDE_MAX_PAIRS = 4096


def coop_lanes(n: int) -> int:
    """Lanes per child for a batch of n pairs.  Where the batch leaves the
    card idle (the main path's ~10^3 pairs), the widest speculation
    shortens the serial chain most; where it fills the card (~10^5 pairs),
    speculation's extra evaluations (2^d - 1 per d levels) cost issue
    slots, and the narrowest groups win.  From a same-run sweep of 4, 8
    and 16 lanes on the card at 883 and 116 865 pairs (PERF.md)."""
    return 16 if n <= WIDE_MAX_PAIRS else 4


def first_max_lanes(f, nvalid, group: int):
    """Plain emulation of `group_first_max` (csrc/polyblock.cu) for pairs on
    `group` lanes each: f (m, n) store values, nvalid (n,) written slots.
    Lane g scans slots g, g + group, ... below nvalid in ascending order
    with a strict >; a butterfly then keeps the larger value and, on equal
    values, the lower slot.  Returns every lane's (value, slot), each
    (group, n) — all lanes agree, on the serial scan's first max."""
    m, n = f.shape
    big = torch.iinfo(torch.int64).max
    bf = torch.full((group, n), -torch.inf, dtype=f.dtype)
    bi = torch.full((group, n), big, dtype=torch.int64)
    for g in range(group):
        for s in range(g, m, group):
            take = (s < nvalid) & ((bi[g] == big) | (f[s] > bf[g]))
            bf[g] = torch.where(take, f[s], bf[g])
            bi[g] = torch.where(take, s, bi[g])
    off = group // 2
    while off:
        partner = torch.arange(group) ^ off
        of, oi = bf[partner], bi[partner]
        take = (of > bf) | ((of == bf) & (oi < bi))
        bf, bi = torch.where(take, of, bf), torch.where(take, oi, bi)
        off //= 2
    return bf, bi


def polyblock_solve_plain(beta, h2, e_max, cfg: WirelessConfig, *,
                          eps: float = 0.01, max_iter: int = 64,
                          n_bisect: int = 60):
    """Plain torch Algorithm 1 over pairs (n,) -> (tau, p, time_s, iters)."""
    n = beta.shape[0]
    m = max_iter + 1          # slot t + 1 is written at iteration t
    dt, dev = beta.dtype, beta.device

    def project(tau_v, p_v):
        pj = project_bisect(torch.stack([tau_v, p_v], -1), beta, h2, e_max,
                            cfg, n_bisect=n_bisect)
        return pj[:, 0], pj[:, 1]

    def neg_time(tau, p):
        return -total_time(tau, p, beta, h2, cfg)

    one = torch.ones(n, dtype=dt, device=dev)
    pj0_tau, pj0_p = project(one, one)
    f0 = neg_time(pj0_tau, pj0_p)

    # Vertex store: five (m, n) tensors; fval == -inf marks an unwritten slot.
    verts_tau = torch.zeros(m, n, dtype=dt, device=dev)
    verts_p = torch.zeros(m, n, dtype=dt, device=dev)
    proj_tau = torch.zeros(m, n, dtype=dt, device=dev)
    proj_p = torch.zeros(m, n, dtype=dt, device=dev)
    vfval = torch.full((m, n), -torch.inf, dtype=dt, device=dev)
    verts_tau[0], verts_p[0] = one, one
    proj_tau[0], proj_p[0], vfval[0] = pj0_tau, pj0_p, f0
    slot = torch.arange(m, device=dev)[:, None]

    active = torch.ones(n, dtype=torch.bool, device=dev)
    prev_best = torch.full((n,), torch.inf, dtype=dt, device=dev)
    best_f, best_tau, best_p = f0, pj0_tau, pj0_p
    iters = torch.zeros(n, dtype=torch.int32, device=dev)
    nvalid = torch.ones(n, dtype=torch.int64, device=dev)

    t = 0
    while t < max_iter and bool(active.any()):
        # Selection half-step: first max over the slot axis (min index).
        fbest = vfval.max(0).values
        idx = torch.where(vfval == fbest, slot, m).min(0).values
        sel = slot == idx
        pick = lambda store: store.gather(0, idx[None])[0]
        sel_ptau, sel_pp = pick(proj_tau), pick(proj_p)
        improved = fbest > best_f
        best_f = torch.where(improved, fbest, best_f)
        best_tau = torch.where(improved, sel_ptau, best_tau)
        best_p = torch.where(improved, sel_pp, best_p)
        done = (fbest - prev_best).abs() <= eps            # eq. (26)
        prev_best = fbest
        active = active & ~done
        iters = iters + active.to(torch.int32)

        # Children half-step (eq. 23): split the chosen vertex at its
        # projection and project both children.
        v_tau, v_p = pick(verts_tau), pick(verts_p)
        c1_tau, c1_p = project(sel_ptau, v_p)
        c2_tau, c2_p = project(v_tau, sel_pp)
        f1, f2 = neg_time(c1_tau, c1_p), neg_time(c2_tau, c2_p)

        # eq. (24): child1 replaces the split slot, child2 takes the first
        # free one; retired pairs keep their store.
        mask1 = sel & active
        mask2 = (slot == nvalid) & active
        write = lambda store, a, b: torch.where(
            mask1, a, torch.where(mask2, b, store))
        verts_tau = write(verts_tau, sel_ptau, v_tau)
        verts_p = write(verts_p, v_p, sel_pp)
        proj_tau = write(proj_tau, c1_tau, c2_tau)
        proj_p = write(proj_p, c1_p, c2_p)
        vfval = write(vfval, f1, f2)
        nvalid = nvalid + active.to(torch.int64)
        t += 1
    return best_tau, best_p, -best_f, iters


def polyblock_solve_fused(beta, h2, e_max, cfg: WirelessConfig, *,
                          eps: float = 0.01, max_iter: int = 64,
                          n_bisect: int = 60, lanes: int | None = None):
    """Solve n feasible pairs: beta / h2 / e_max (n,), one dtype (float64 or
    float32), one device, contiguous.  Returns (tau, p, time_s) in that
    dtype and iterations as int32.

    A CUDA tensor launches the kernel with `lanes` lanes per child (one of
    LANES; None: `coop_lanes(n)`), every choice giving the same bits; a CPU
    tensor runs `polyblock_solve_plain`.  With lanes > 1 the vertex store
    lives in shared memory, so max_iter is capped (about 1 800 in float64
    at 4 lanes); a larger one raises.
    """
    if lanes is not None and lanes not in LANES:
        raise ValueError(f"polyblock_solve_fused: lanes must be one of {LANES}, got {lanes}")
    if beta.device.type == "cpu":
        return polyblock_solve_plain(beta, h2, e_max, cfg, eps=eps,
                                     max_iter=max_iter, n_bisect=n_bisect)
    if beta.device.type != "cuda":
        raise ValueError(f"polyblock_solve_fused: unsupported device {beta.device}")
    if beta.dtype not in _DTYPES or beta.ndim != 1:
        raise ValueError(f"polyblock_solve_fused: beta must be 1-D float64/"
                         f"float32, got {tuple(beta.shape)} {beta.dtype}")
    n = beta.shape[0]
    for name, x in (("beta", beta), ("h2", h2), ("e_max", e_max)):
        if (not isinstance(x, torch.Tensor) or x.shape != (n,)
                or x.dtype != beta.dtype or x.device != beta.device):
            raise ValueError(f"polyblock_solve_fused: {name} must be a ({n},) "
                             f"{beta.dtype} tensor on {beta.device}")
        if not x.is_contiguous():
            raise ValueError(f"polyblock_solve_fused: {name} is not contiguous")
    if max_iter < 1:
        raise ValueError(f"polyblock_solve_fused: max_iter must be >= 1, got {max_iter}")
    lib = load_polyblock()
    lanes = coop_lanes(n) if lanes is None else lanes
    if lanes > 1:
        limit = lib.polyblock_solve_max_iter(lanes, beta.element_size())
        if max_iter > limit:
            raise ValueError(
                f"polyblock_solve_fused: max_iter={max_iter} needs a vertex store of "
                f"{(max_iter + 1) * 4 * beta.element_size()} bytes per pair, and at "
                f"{lanes} lanes per child the 227 KB of shared memory a block may use "
                f"holds max_iter <= {limit}; pass lanes=1 (store in global memory)")
    tau, p, time_s = (torch.empty_like(beta) for _ in range(3))
    iters = torch.empty(n, dtype=torch.int32, device=beta.device)
    if n == 0:
        return tau, p, time_s, iters
    # lanes=1: the vertex store in a global scratch laid out [slot][field][pair];
    # lanes > 1: the counter the pair groups claim their next pairs from.
    store = (torch.empty((max_iter + 1) * 5 * n, dtype=beta.dtype, device=beta.device)
             if lanes == 1 else torch.empty(1, dtype=torch.int64, device=beta.device))
    fn = (lib.polyblock_solve_f64 if beta.dtype == torch.float64
          else lib.polyblock_solve_f32)
    with torch.cuda.device(beta.device):
        err = fn(beta.data_ptr(), h2.data_ptr(), e_max.data_ptr(),
                 tau.data_ptr(), p.data_ptr(), time_s.data_ptr(),
                 iters.data_ptr(), store.data_ptr(), n,
                 float(eps), int(max_iter), int(n_bisect), int(lanes),
                 cfg.kappa0 * cfg.mu_cycles, cfg.mu_cycles, cfg.cpu_hz, cfg.pt_w,
                 cfg.model_bits, cfg.bandwidth_hz,
                 torch.cuda.current_stream(beta.device).cuda_stream)
    check_launch(err, "polyblock_solve_fused")
    count_launches(polyblock_solve_fused)
    return tau, p, time_s, iters


polyblock_solve_fused.launches = 0
