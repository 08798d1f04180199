"""Proposition 1: energy-feasibility of a (device, sub-channel) pair.

A selected device n on sub-channel k cannot complete its uplink within the
energy budget iff

    ln(2) * P_t * D(w) >= E_n^max * B * |h_{k,n}|^2        (eq. 15)

This is exactly the p -> 0+ limit of the communication-energy term: as the
power fraction vanishes, E^cm -> ln(2) P_t D / (B |h|^2), the *infimum* of
communication energy; if even that exceeds the budget, no (tau, p) in (0,1]^2
is feasible.

Backend-agnostic like `core.wireless` (DESIGN.md §6): numpy in, numpy out;
torch tensors in, torch out.
"""
from __future__ import annotations

import numpy as np

from .wireless import WirelessConfig, _asfloat, _xp

__all__ = ["min_comm_energy", "is_infeasible", "feasible_mask"]


def min_comm_energy(h2, cfg: WirelessConfig):
    """Infimum over p in (0,1] of E^cm(p) = p P_t D / (B log2(1+p|h|^2)).

    E^cm is increasing in p (Proposition 2), so the infimum is the p->0 limit:
    ln(2) P_t D / (B |h|^2).
    """
    xp = _xp(h2)
    h2 = _asfloat(xp, h2)
    return xp.divide(np.log(2.0) * cfg.pt_w * cfg.model_bits,
                     cfg.bandwidth_hz * xp.maximum(h2, 1e-300))


def is_infeasible(h2, cfg: WirelessConfig, e_max=None):
    """Eq. (15) per element; True where the pair can never meet the budget."""
    e_max = cfg.e_max_j if e_max is None else e_max
    return min_comm_energy(h2, cfg) >= _asfloat(_xp(h2, e_max), e_max)


def feasible_mask(h2, cfg: WirelessConfig, e_max=None):
    """Boolean mask (same shape as h2) of *feasible* pairs."""
    return ~is_infeasible(h2, cfg, e_max)
