"""Proposition 3: upper bound on the FedAvg convergence gap under partial
participation (paper Sec. V, eq. 40).

    E[F(w^{t+1}) - F(w*)] <= (1 - mu/L)^t E[F(w^1) - F(w*)]
        + (2 rho / L) sum_{i=1}^t (1 - mu/L)^{t-i}
            * ||grad F(w^i)||^2 / (sum_n beta_n)
            * sum_n beta_n (1 - S_n^i sum_k psi_kn^i)

The learning plane records ||grad F||^2 and the transmitted masks each round;
this module evaluates the bound so tests/benchmarks can check that the
*measured* gap stays below it (for strongly-convex objectives) and that
selecting more data per round tightens it.

A NumPy copy of the JAX package's `core/convergence.py`, held bitwise equal
to it by tests/test_torch_experiments.py.
"""
from __future__ import annotations

import numpy as np

__all__ = ["convergence_bound", "participation_deficit"]


def participation_deficit(beta: np.ndarray, transmitted: np.ndarray) -> float:
    """sum_n beta_n (1 - S_n sum_k psi_kn)  -- the data left out this round."""
    beta = np.asarray(beta, np.float64)
    tx = np.asarray(transmitted).astype(np.float64)
    return float((beta * (1.0 - tx)).sum())


def convergence_bound(
    gap0: float,
    grad_sq_norms: np.ndarray,
    deficits: np.ndarray,
    beta_total: float,
    *,
    mu: float,
    lips: float,
    rho: float,
) -> np.ndarray:
    """Evaluate eq. (40) for every round t = 1..T.

    Args:
      gap0: E[F(w^1) - F(w*)].
      grad_sq_norms: (T,) ||grad F(w^i)||^2 for i = 1..T.
      deficits: (T,) participation deficits per round.
      beta_total: sum_n beta_n.
      mu, lips, rho: strong-convexity, Lipschitz, gradient-diversity constants.

    Returns:
      (T,) bound on E[F(w^{t+1}) - F(w*)].
    """
    grad_sq_norms = np.asarray(grad_sq_norms, np.float64)
    deficits = np.asarray(deficits, np.float64)
    t_max = grad_sq_norms.shape[0]
    r = 1.0 - mu / lips
    if not (0.0 <= r < 1.0):
        raise ValueError("need 0 < mu <= L")
    bounds = np.empty(t_max)
    acc = 0.0
    for t in range(t_max):
        # acc = sum_{i<=t} r^{t-i} * term_i, built incrementally.
        acc = r * acc + grad_sq_norms[t] * deficits[t] / beta_total
        bounds[t] = (r ** (t + 1)) * gap0 + (2.0 * rho / lips) * acc
    return bounds
