"""K2: the polyblock projection (eqs. 27-29) — plain torch and CUDA.

Projection phi(v) = zeta * v of each vertex v = (tau, p) onto the upper
boundary of G = {z : g(z) <= 0}: `n_bisect` halvings of (TINY, 1] on
g(zeta tau, zeta p) = 0, keeping the feasible lo side; zeta = 1 where v is
already feasible.

  project_bisect    -- the plain torch version, the mirror of the JAX
                       package's `project_jnp` (same arithmetic, same order);
  polyblock_project -- the wrapper of the CUDA kernel `project_kernel`
                       (csrc/polyblock.cu), which replaces the Pallas kernel
                       `kernels/polyblock_project/kernel.py::_project_kernel`.
"""
from __future__ import annotations

import torch

from ...core.wireless import WirelessConfig, total_energy
from .._build import check_launch, load_polyblock
from .ref import TINY

__all__ = ["project_bisect", "polyblock_project"]

_DTYPES = (torch.float64, torch.float32)


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


def polyblock_project(v, beta, h2, e_max, cfg: WirelessConfig, *,
                      n_bisect: int = 60):
    """Project n vertices: v (n, 2), beta / h2 / e_max (n,), one dtype
    (float64 or float32), one device, contiguous.  Returns zeta * v (n, 2).

    A CUDA tensor launches the kernel; a CPU tensor runs `project_bisect`.
    """
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
    lib = load_polyblock()
    fn = (lib.polyblock_project_f64 if v.dtype == torch.float64
          else lib.polyblock_project_f32)
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), beta.data_ptr(), h2.data_ptr(), e_max.data_ptr(),
                 out.data_ptr(), n, int(n_bisect), cfg.kappa0 * cfg.mu_cycles,
                 cfg.cpu_hz, cfg.pt_w, cfg.model_bits, cfg.bandwidth_hz,
                 torch.cuda.current_stream(v.device).cuda_stream)
    check_launch(err, "polyblock_project")
    polyblock_project.launches += 1
    return out


polyblock_project.launches = 0
