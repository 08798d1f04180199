"""NumPy reference for the fused polyblock projection (paper eqs. 27-29).

Projection phi(v) = zeta * v of a vertex v = (tau, p) onto the upper boundary
of the feasible set G = {z : g(z) <= 0}, where g is the energy constraint of
eq. (22).  g is strictly increasing in zeta (Proposition 2), so the root of
g(zeta * v) = 0 is found by bisection: `n_bisect` halvings of (0, 1], keeping
the lo side so the returned point satisfies g <= 0 (feasible).  When the
vertex itself is feasible (g(v) <= 0), zeta = 1 — the paper's theta=1 corner
case.

This is the canonical host-side implementation: `core.monotonic._project`
delegates here, and the plain torch bisection plus the CUDA kernel
(`ops.py`, `csrc/polyblock.cu`) must match it.  A copy of the JAX
package's `kernels/polyblock_project/ref.py`, held bit-identical to it.
"""
from __future__ import annotations

import numpy as np

from ...core.wireless import WirelessConfig, total_energy

__all__ = ["project_ref", "TINY"]

TINY = 1e-12


def project_ref(v, beta, h2, e_max, cfg: WirelessConfig, *, n_bisect: int = 60):
    """Project vertices v[..., 2] = (tau, p) onto the boundary of G.

    All of beta / h2 / e_max broadcast against v[..., 0]. Returns zeta * v.
    """

    def g_con(tau, p):
        return total_energy(tau, p, beta, h2, cfg) - e_max

    tau_v, p_v = v[..., 0], v[..., 1]
    g_at_v = g_con(tau_v, p_v)
    need_root = g_at_v > 0.0

    lo = np.full_like(tau_v, TINY)
    hi = np.ones_like(tau_v)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        g_mid = g_con(mid * tau_v, mid * p_v)
        take_hi = g_mid > 0.0
        hi = np.where(take_hi, mid, hi)
        lo = np.where(take_hi, lo, mid)
    zeta = np.where(need_root, lo, 1.0)  # lo side keeps g <= 0 (feasible)
    return zeta[..., None] * v
