"""K2: the polyblock projection (eqs. 27-29) — plain torch and CUDA.

Projection phi(v) = zeta * v of each vertex v = (tau, p) onto the upper
boundary of G = {z : g(z) <= 0}: `n_bisect` halvings of (TINY, 1] on
g(zeta tau, zeta p) = 0, keeping the feasible lo side; zeta = 1 where v is
already feasible.

  project_bisect    -- the plain torch version, the mirror of the JAX
                       package's `project_jnp` (same arithmetic, same order);
  project_speculative -- a plain emulation of the cooperative projection
                       (`coop_project` in csrc/polyblock.cu, shared by K1
                       and K2), for tests;
  polyblock_project -- the wrapper of the CUDA kernels that replace the
                       Pallas kernel `kernels/polyblock_project/kernel.py::
                       _project_kernel` (csrc/polyblock.cu):
                       `project_coop_kernel`, L = 4, 8 or 16 lanes of a warp
                       per vertex (speculative bisection, chosen from the
                       vertex count by `project_lanes`), or `project_kernel`,
                       one thread per vertex (lanes=1, the reference
                       schedule).
"""
from __future__ import annotations

import torch

from ...core.wireless import WirelessConfig, total_energy
from .._build import check_launch, load_polyblock
from .ref import TINY

__all__ = ["project_bisect", "project_speculative", "polyblock_project", "project_lanes",
           "LANES"]

_DTYPES = (torch.float64, torch.float32)
# Lanes per projection the C entries take (K2 per vertex, K1 per child): 1
# is the one-thread schedule, 4, 8 and 16 the speculative `coop_project`.
LANES = (1, 4, 8, 16)
# Vertex counts up to WIDE_MAX_VERTICES take 16 lanes per vertex, up to
# NARROW_MAX_VERTICES 4, larger ones 1 (the same-run sweep in PERF.md).
WIDE_MAX_VERTICES = 4096
NARROW_MAX_VERTICES = 16384


def project_lanes(n: int) -> int:
    """Lanes per vertex for a batch of n vertices.  Where the batch leaves
    the card idle (the step driver's few hundred vertices per call), one
    vertex's chain of dependent evaluations is the kernel's time, and the
    widest speculation shortens it most (61 -> 16 evaluations); as the
    batch fills the card, speculation's extra evaluations (2^d - 1 per d
    levels) cost issue slots, first at 16 lanes, then at 4.  From a
    same-run sweep of 1, 4, 8 and 16 lanes on the card (PERF.md)."""
    if n <= WIDE_MAX_VERTICES:
        return 16
    return 4 if n <= NARROW_MAX_VERTICES else 1


def project_bisect(v, beta, h2, e_max, cfg: WirelessConfig, *,
                   n_bisect: int = 60):
    """Plain torch projection of vertices v[..., 2] = (tau, p); beta, h2 and
    e_max broadcast against v[..., 0].  Returns zeta * v."""
    tau_v, p_v = v[..., 0], v[..., 1]

    def g_con(tau, p):
        return total_energy(tau, p, beta, h2, cfg) - e_max

    need_root = g_con(tau_v, p_v) > 0.0
    lo = torch.full_like(tau_v, TINY)
    hi = torch.ones_like(tau_v)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        take_hi = g_con(mid * tau_v, mid * p_v) > 0.0
        lo, hi = torch.where(take_hi, lo, mid), torch.where(take_hi, mid, hi)
    zeta = torch.where(need_root, lo, 1.0)
    return zeta[..., None] * v


def project_speculative(v, beta, h2, e_max, cfg: WirelessConfig, *,
                        n_bisect: int = 60, depth: int = 4):
    """Plain emulation of K1's speculative bisection (`coop_project`): per
    round, the 2^depth - 1 nodes of the next `depth` levels of the
    bisection tree are evaluated at once — node r (heap order) reaches its
    (lo, hi) by the halvings of its own path, r's bits below the leading
    one, 1 = the g > 0 branch — and the signs then walk the levels; the
    last round covers n_bisect % depth.  A bracket whose halving no longer
    moves an end is settled and evaluates nothing more: at mid == lo no
    later halving changes lo, and at mid == hi neither (g > 0 at every hi:
    hi is 1 with g(v) > 0, or a midpoint whose g was > 0).  Bit for bit
    `project_bisect`."""
    tau_v, p_v = v[..., 0], v[..., 1]

    def g_con(tau, p):
        return total_energy(tau, p, beta, h2, cfg) - e_max

    need_root = g_con(tau_v, p_v) > 0.0
    lo = torch.full_like(tau_v, TINY)
    hi = torch.ones_like(tau_v)
    settled = torch.zeros_like(need_root)
    for done in range(0, n_bisect, depth):
        mid0 = 0.5 * (lo + hi)
        settled = settled | (mid0 == lo) | (mid0 == hi)
        go = need_root & ~settled
        if not bool(go.any()):
            break
        levels = min(depth, n_bisect - done)
        signs = [torch.zeros_like(need_root)]          # node 0: no node
        for r in range(1, 1 << levels):
            lo_r, hi_r = lo, hi
            for b in range(r.bit_length() - 2, -1, -1):
                mid = 0.5 * (lo_r + hi_r)
                lo_r, hi_r = (lo_r, mid) if (r >> b) & 1 else (mid, hi_r)
            mid = 0.5 * (lo_r + hi_r)
            signs.append(g_con(mid * tau_v, mid * p_v) > 0.0)
        signs = torch.stack(signs)
        node = torch.ones_like(tau_v, dtype=torch.int64)
        for _ in range(levels):
            mid = 0.5 * (lo + hi)
            take_hi = signs.gather(0, node[None])[0]
            lo = torch.where(go & ~take_hi, mid, lo)
            hi = torch.where(go & take_hi, mid, hi)
            node = 2 * node + take_hi.to(torch.int64)
    zeta = torch.where(need_root, lo, 1.0)
    return zeta[..., None] * v


def polyblock_project(v, beta, h2, e_max, cfg: WirelessConfig, *,
                      n_bisect: int = 60, lanes: int | None = None):
    """Project n vertices: v (n, 2), beta / h2 / e_max (n,), one dtype
    (float64 or float32), one device, contiguous.  Returns zeta * v (n, 2).

    A CUDA tensor launches the kernel with `lanes` lanes per vertex (one of
    LANES; None: `project_lanes(n)`), every choice giving the same bits; a
    CPU tensor runs `project_bisect`.
    """
    if lanes is not None and lanes not in LANES:
        raise ValueError(f"polyblock_project: lanes must be one of {LANES}, got {lanes}")
    if v.device.type == "cpu":
        return project_bisect(v, beta, h2, e_max, cfg, n_bisect=n_bisect)
    if v.device.type != "cuda":
        raise ValueError(f"polyblock_project: unsupported device {v.device}")
    if v.dtype not in _DTYPES or v.ndim != 2 or v.shape[1] != 2:
        raise ValueError(f"polyblock_project: v must be (n, 2) float64/float32, "
                         f"got {tuple(v.shape)} {v.dtype}")
    n = v.shape[0]
    for name, x in (("beta", beta), ("h2", h2), ("e_max", e_max)):
        if (not isinstance(x, torch.Tensor) or x.shape != (n,)
                or x.dtype != v.dtype or x.device != v.device):
            raise ValueError(f"polyblock_project: {name} must be a ({n},) "
                             f"{v.dtype} tensor on {v.device}")
    for name, x in (("v", v), ("beta", beta), ("h2", h2), ("e_max", e_max)):
        if not x.is_contiguous():
            raise ValueError(f"polyblock_project: {name} is not contiguous")
    out = torch.empty_like(v)
    if n == 0:
        return out
    lanes = project_lanes(n) if lanes is None else lanes
    lib = load_polyblock()
    fn = (lib.polyblock_project_f64 if v.dtype == torch.float64
          else lib.polyblock_project_f32)
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), beta.data_ptr(), h2.data_ptr(), e_max.data_ptr(),
                 out.data_ptr(), n, int(n_bisect), int(lanes), cfg.kappa0 * cfg.mu_cycles,
                 cfg.cpu_hz, cfg.pt_w, cfg.model_bits, cfg.bandwidth_hz,
                 torch.cuda.current_stream(v.device).cuda_stream)
    check_launch(err, "polyblock_project")
    polyblock_project.launches += 1
    return out


polyblock_project.launches = 0
