"""Age-of-Update state machine (paper Sec. II-C, eqs. 6-7, Fig. 1).

A_n counts communication rounds since device n last *transmitted* (selected
AND assigned to a sub-channel).  alpha_n = A_n / sum_i A_i is the selection
weight: devices skipped for longer carry fresher/more informative updates and
get prioritized.
"""
from __future__ import annotations

import dataclasses
import numpy as np

__all__ = ["AoUState", "init_aou", "step_aou", "aou_weights"]


@dataclasses.dataclass
class AoUState:
    """Age-of-Update state: per-device rounds since last update (eq. 6).

    `age[n]` is A_n >= 1; `weights` exposes the normalized alpha_n of
    eq. (7) used by the eq.-43 selection priority."""

    age: np.ndarray  # (N,) int64, A_n >= 1

    @property
    def weights(self) -> np.ndarray:
        """alpha_n of eq. (7)."""
        return self.age.astype(np.float64) / float(self.age.sum())


def init_aou(n_devices: int) -> AoUState:
    """All devices start with age 1 (every update equally fresh at t=1)."""
    return AoUState(age=np.ones(n_devices, dtype=np.int64))


def step_aou(state: AoUState, transmitted: np.ndarray) -> AoUState:
    """Eq. (6).  `transmitted[n] = S_n * sum_k psi_{k,n}` for the round just
    finished: 1 iff device n was selected *and* assigned a sub-channel (and
    hence its local model reached the server)."""
    transmitted = np.asarray(transmitted).astype(bool)
    if transmitted.shape != state.age.shape:
        raise ValueError("transmitted mask has wrong shape")
    new_age = np.where(transmitted, 1, state.age + 1)
    return AoUState(age=new_age.astype(np.int64))


def aou_weights(state: AoUState) -> np.ndarray:
    """Normalized AoU weights alpha_n = A_n / sum_i A_i (eq. 7)."""
    return state.weights
