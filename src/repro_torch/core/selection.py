"""Algorithm 3: AoU-based device selection (paper Sec. V) + the benchmark
selection schemes of Sec. VI.

The leader (server) reformulates global-loss minimization as the weighted
selection problem (eq. 42): maximize sum_n alpha_n beta_n S_n sum_k psi_kn.
Devices are ranked by priority alpha_n * beta_n (eq. 43); the top-K are
proposed, the follower's sub-channel assignment is *predicted*, and any
device that cannot be assigned a feasible sub-channel is replaced by the
next unselected device in the priority list until either all K sub-channels
carry a transmitting device or the list is exhausted.
"""
from __future__ import annotations

import dataclasses
import numpy as np

from .matching import MatchResult, swap_matching, random_assignment, U_MAX

__all__ = [
    "SelectionOutcome",
    "priority_list",
    "select_aou_alg3",
    "select_topk",
    "select_random",
    "select_cluster",
    "select_fixed",
]


@dataclasses.dataclass(frozen=True)
class SelectionOutcome:
    """One device-selection decision: the leader's set S_n plus the
    predicted follower matching over it (Algorithm 3 / Sec.-VI schemes)."""

    selected: np.ndarray          # (N,) bool, S_n
    channel_of: np.ndarray        # (N,) int, assigned sub-channel or -1
    transmitted: np.ndarray       # (N,) bool, S_n * sum_k psi_kn == 1 AND feasible
    match: MatchResult | None     # final follower matching (over the selected set)
    selected_ids: np.ndarray      # (n_sel,) device ids in matching order
    iterations: int               # Algorithm-3 replacement iterations


def priority_list(alpha: np.ndarray, beta: np.ndarray) -> np.ndarray:
    """Eq. (43): device ids sorted by alpha_n * beta_n, descending.

    Ties broken by device id for determinism (stable sort on -priority).
    """
    prio = np.asarray(alpha, np.float64) * np.asarray(beta, np.float64)
    return np.argsort(-prio, kind="stable")


def _assign(gamma, feasible, ids, sa, rng, assign_perm=None):
    """Run the follower's sub-channel assignment over the candidate set.

    `assign_perm` optionally injects the K-permutation used as the initial
    matching (M-SA) or the assignment itself (R-SA) in place of an `rng`
    draw, so the host loop and the scan engine share one randomness stream
    (DESIGN.md §8).  Within an Algorithm-3 replacement loop the same
    injected permutation is reused for every iteration — a documented
    deviation from the legacy per-iteration draw.
    """
    sub_gamma = gamma[:, ids]
    sub_feas = feasible[:, ids]
    n_sel = len(ids)
    initial = None if assign_perm is None else np.asarray(assign_perm)[:n_sel]
    if sa == "matching":
        return swap_matching(sub_gamma, sub_feas, rng, initial=initial)
    elif sa == "random":
        return random_assignment(sub_gamma, sub_feas, rng, perm=assign_perm)
    raise ValueError(f"unknown sub-channel assignment scheme: {sa}")


def _finalize(n, ids, match: MatchResult, iterations: int) -> SelectionOutcome:
    selected = np.zeros(n, dtype=bool)
    channel_of = np.full(n, -1, dtype=np.int64)
    transmitted = np.zeros(n, dtype=bool)
    selected[ids] = True
    channel_of[ids] = np.where(match.feasible, match.assignment, -1)
    transmitted[ids] = match.feasible
    return SelectionOutcome(
        selected=selected,
        channel_of=channel_of,
        transmitted=transmitted,
        match=match,
        selected_ids=ids,
        iterations=iterations,
    )


def select_aou_alg3(
    alpha: np.ndarray,
    beta: np.ndarray,
    gamma: np.ndarray,
    feasible: np.ndarray,
    rng: np.random.Generator,
    *,
    sa: str = "matching",
    max_iter: int | None = None,
    assign_perm: np.ndarray | None = None,
) -> SelectionOutcome:
    """The proposed scheme: Algorithm 3 with follower prediction.

    Args:
      gamma:    (K, N) minimum-time matrix over ALL devices (Algorithm 1).
      feasible: (K, N) Proposition-1 feasibility over all devices.
    """
    k, n = gamma.shape
    order = priority_list(alpha, beta)
    n_take = min(k, n)
    ids = list(order[:n_take])
    next_ptr = n_take
    max_iter = n if max_iter is None else max_iter

    it = 0
    while True:
        it += 1
        match = _assign(gamma, feasible, np.asarray(ids), sa, rng, assign_perm)
        unfeas = [i for i, ok in enumerate(match.feasible) if not ok]
        # Paper line 6: stop when every sub-channel carries a transmitting
        # device, or the priority list is exhausted.
        if not unfeas or next_ptr >= n or it >= max_iter:
            break
        replaced = False
        for i in unfeas:
            if next_ptr >= n:
                break
            ids[i] = order[next_ptr]      # lines 9-10: replace with next in Q
            next_ptr += 1
            replaced = True
        if not replaced:
            break
    return _finalize(n, np.asarray(ids), match, it)


def select_topk(
    alpha, beta, gamma, feasible, rng, *, sa: str = "matching",
    assign_perm: np.ndarray | None = None,
) -> SelectionOutcome:
    """"AoU based DS" benchmark: top-K of eq. (43), no replacement loop."""
    k, n = gamma.shape
    ids = priority_list(alpha, beta)[: min(k, n)]
    match = _assign(gamma, feasible, ids, sa, rng, assign_perm)
    return _finalize(n, ids, match, 1)


def select_random(gamma, feasible, rng, *, sa: str = "matching",
                  sel_perm: np.ndarray | None = None,
                  assign_perm: np.ndarray | None = None) -> SelectionOutcome:
    """Random DS benchmark: K devices uniformly at random.

    `sel_perm` optionally injects the device permutation (scan-engine
    stream sharing, DESIGN.md §8)."""
    k, n = gamma.shape
    perm = rng.permutation(n) if sel_perm is None else np.asarray(sel_perm)
    ids = perm[: min(k, n)]
    match = _assign(gamma, feasible, ids, sa, rng, assign_perm)
    return _finalize(n, ids, match, 1)


def select_cluster(
    gamma, feasible, rng, round_idx: int, clusters: np.ndarray, *,
    sa: str = "matching", assign_perm: np.ndarray | None = None,
) -> SelectionOutcome:
    """Cluster-based DS: devices pre-partitioned into ceil(N/K) clusters,
    clusters selected in rotation."""
    k, n = gamma.shape
    n_clusters = int(clusters.max()) + 1
    ids = np.where(clusters == (round_idx % n_clusters))[0][: min(k, n)]
    match = _assign(gamma, feasible, ids, sa, rng, assign_perm)
    return _finalize(n, ids, match, 1)


def select_fixed(gamma, feasible, rng, fixed_ids: np.ndarray, *,
                 sa: str = "matching",
                 assign_perm: np.ndarray | None = None) -> SelectionOutcome:
    """Fixed DS: the same K devices every round."""
    match = _assign(gamma, feasible, np.asarray(fixed_ids), sa, rng, assign_perm)
    return _finalize(gamma.shape[1], np.asarray(fixed_ids), match, 1)
