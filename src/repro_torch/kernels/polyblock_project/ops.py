"""K2: the polyblock projection (eqs. 27-29) — plain torch and CUDA.

Projection phi(v) = zeta * v of each vertex v = (tau, p) onto the upper
boundary of G = {z : g(z) <= 0}: the root of g(zeta tau, zeta p) = 0 on
(TINY, 1], on the feasible side; zeta = 1 where v is already feasible.

  project_bisect    -- the plain torch version, the mirror of the JAX
                       package's `project_jnp` (same arithmetic, same order):
                       `n_bisect` halvings of (TINY, 1], keeping lo;
  project_newton    -- the mirror of the JAX package's `project_newton`:
                       safeguarded log-space Newton, 14 steps, float64;
  project_newton_mixed -- the mirror of its `project_newton_mixed`: a
                       float32 Newton bulk, then float64 Halley polish;
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
                       schedule);
  project           -- the dispatcher by backend name, the counterpart of
                       the JAX package's `polyblock_project(backend=)`.

The Newton projections are plain torch functions, not kernels: on a CUDA
tensor they run as torch ops on the card.
"""
from __future__ import annotations

import math

import torch

from ...core.wireless import WirelessConfig, _TorchOps, total_energy
from .._build import check_launch, count_launches, load_polyblock
from .ref import TINY, project_ref

__all__ = ["project_bisect", "project_newton", "project_newton_mixed",
           "project_speculative", "polyblock_project", "project", "project_lanes",
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


def _newton_coefs(tau_v, p_v, beta, h2, cfg: WirelessConfig):
    """a, b, c of g(x) = a x^2 + b x / log1p(c x) - e_max on the ray x v
    (`project_newton`), in the JAX package's order of operations."""
    a = cfg.kappa0 * cfg.mu_cycles * beta * (tau_v * cfg.cpu_hz) ** 2
    b = p_v * cfg.pt_w * cfg.model_bits * math.log(2.0) / cfg.bandwidth_hz
    return a, b, p_v * h2


def _g_gp(x, a, b, c, e_max, floor: float):
    """g and g' at x, sharing one log1p (`floor` keeps log1p off 0)."""
    u = c * x
    el = torch.log1p(u)
    elc = torch.clamp_min(el, floor)
    g = a * x * x + b * x / elc - e_max
    gp = 2.0 * a * x + b * (el - u / (1.0 + u)) / (elc * elc)
    return g, gp


def project_newton(v, beta, h2, e_max, cfg: WirelessConfig, *, n_steps: int = 14):
    """Safeguarded log-space Newton root of g(zeta v) = 0 on (0, 1]: the
    mirror of the JAX package's `project_newton` (same arithmetic, same
    order).  Each step takes cand = x exp(-g / (x g')) where it falls
    strictly inside the bisection bracket, else the bracket's geometric
    mean; the start is the root of the low-SNR limit,
    sqrt((e_max - b/c) / a).  float64 in, float64 out; v[..., 2] = (tau, p),
    beta / h2 / e_max broadcast against v[..., 0].  Returns zeta * v."""
    tau_v, p_v = v[..., 0], v[..., 1]
    a, b, c = _newton_coefs(tau_v, p_v, beta, h2, cfg)
    need_root = _g_gp(torch.ones_like(tau_v), a, b, c, e_max, 1e-300)[0] > 0.0
    x = torch.sqrt(torch.clamp_min(e_max - b / torch.clamp_min(c, 1e-300), 1e-300)
                   / torch.clamp_min(a, 1e-300))
    x = torch.clamp(x, TINY, 1.0 - 1e-9)
    lo = torch.full_like(tau_v, TINY)
    hi = torch.ones_like(tau_v)
    for _ in range(n_steps):
        g, gp = _g_gp(x, a, b, c, e_max, 1e-300)
        pos = g > 0.0
        lo = torch.where(pos, lo, x)
        hi = torch.where(pos, x, hi)
        cand = x * torch.exp(-g / (x * gp))
        ok = (cand > lo) & (cand < hi)
        x = torch.where(ok, cand, torch.sqrt(lo * hi))
    zeta = torch.where(need_root, torch.clamp(x, TINY, 1.0), 1.0)
    return zeta[..., None] * v


def project_newton_mixed(v, beta, h2, e_max, cfg: WirelessConfig, *,
                         n_f32: int = 6, n_f64: int = 2, x0_hint=None):
    """Mixed-precision Newton: the mirror of the JAX package's
    `project_newton_mixed` (same arithmetic, same order).

    `n_f32` safeguarded log-space Newton steps in float32 (boundary-equal
    candidates accepted, `>=`) from the regime-split warm start — the
    positive root of a x^2 + (b/2) x = q where c x stays below 1/2, else
    sqrt(q / a), q = e_max - b/c — raised to `x0_hint` where the hint is
    finite (the parent vertex's zeta, a lower bound on a child's root);
    then `n_f64` float64 Halley steps from that root in a fresh bracket,
    keeping x where the candidate leaves it.  Whether a vertex needs a
    root (g(v) > 0) is decided in float64: a vertex with g(v) within
    float32 noise of 0 must classify as the float64 backends do.
    float64 in, float64 out.  Returns zeta * v."""
    tau_v, p_v = v[..., 0], v[..., 1]
    a, b, c = _newton_coefs(tau_v, p_v, beta, h2, cfg)

    # float32 bulk: every operand cast down.
    f32 = torch.float32
    a32, b32, c32 = a.to(f32), b.to(f32), c.to(f32)
    e32 = torch.as_tensor(e_max, device=tau_v.device).to(f32)
    q = torch.clamp_min(e32 - b32 / torch.clamp_min(c32, 1e-38), 1e-38)
    bh = 0.5 * b32
    a_s = torch.clamp_min(a32, 1e-38)
    x_quad = 2.0 * q / (bh + torch.sqrt(bh * bh + 4.0 * a_s * q))
    x_sqrt = torch.sqrt(q / a_s)
    x0 = torch.where(c32 * x_quad < 0.5, x_quad, x_sqrt)
    if x0_hint is not None:
        h32 = x0_hint.to(f32)
        x0 = torch.where(torch.isfinite(h32), torch.maximum(x0, h32), x0)
    x = torch.clamp(x0, TINY, 1.0 - 1e-7)
    lo = torch.full_like(x, TINY)
    hi = torch.ones_like(x)
    for _ in range(n_f32):
        g, gp = _g_gp(x, a32, b32, c32, e32, 1e-38)
        pos = g > 0.0
        lo = torch.where(pos, lo, x)
        hi = torch.where(pos, x, hi)
        cand = x * torch.exp(-g / (x * gp))
        ok = (cand >= lo) & (cand <= hi)
        x = torch.where(ok, cand, torch.sqrt(lo * hi))

    # float64 Halley polish: g'' is algebraic once log1p(u) is in hand.
    need_root = _g_gp(torch.ones_like(tau_v), a, b, c, e_max, 1e-300)[0] > 0.0
    x = torch.clamp(x.to(tau_v.dtype), TINY, 1.0 - 1e-12)
    lo = torch.full_like(tau_v, TINY)
    hi = torch.ones_like(tau_v)
    for _ in range(n_f64):
        u = c * x
        el = torch.log1p(u)
        elc = torch.clamp_min(el, 1e-300)
        t1 = _TorchOps.divide(1.0, 1.0 + u)
        w = u * t1
        g = a * x * x + b * x / elc - e_max
        gp = 2.0 * a * x + b * (el - w) / (elc * elc)
        g2 = 2.0 * a + b * c * t1 * ((1.0 - t1) / (elc * elc)
                                     - 2.0 * (el - w) / (elc * elc * elc))
        pos = g > 0.0
        lo = torch.where(pos, lo, x)
        hi = torch.where(pos, x, hi)
        cand = x - 2.0 * g * gp / (2.0 * gp * gp - g * g2)
        ok = (cand >= lo) & (cand <= hi)
        x = torch.where(ok, cand, x)
    zeta = torch.where(need_root, torch.clamp(x, TINY, 1.0), 1.0)
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
    count_launches(polyblock_project)
    return out


polyblock_project.launches = 0



def project(v, beta, h2, e_max, cfg: WirelessConfig, *, backend: str = "cuda",
            n_bisect: int = 60):
    """Project a batch of vertices by the named backend: "ref" (the NumPy
    bisection, numpy in and out), "bisect" (alias "jnp", `project_bisect`),
    "newton" (`project_newton`), "mixed" (`project_newton_mixed`) or
    "cuda" (alias "pallas": kernel K2 through `polyblock_project`, whose
    plain version runs on CPU tensors).  n_bisect is the halving count of
    the bisection backends; the Newton ones have their own step counts."""
    if backend == "ref":
        return project_ref(v, beta, h2, e_max, cfg, n_bisect=n_bisect)
    if backend in ("bisect", "jnp"):
        return project_bisect(v, beta, h2, e_max, cfg, n_bisect=n_bisect)
    if backend == "newton":
        return project_newton(v, beta, h2, e_max, cfg)
    if backend == "mixed":
        return project_newton_mixed(v, beta, h2, e_max, cfg)
    if backend in ("cuda", "pallas"):
        return polyblock_project(v, beta, h2, e_max, cfg, n_bisect=n_bisect)
    raise ValueError(f"unknown backend: {backend!r} (use 'ref', 'bisect', 'jnp', "
                     f"'newton', 'mixed', 'cuda' or 'pallas')")
