"""Algorithm 2: matching-based sub-channel assignment (paper Sec. IV-B).

One-to-one matching between the selected device set N_t and the K
sub-channels.  Utilities come from the minimum-time matrix Gamma produced by
Algorithm 1; infeasible (device, channel) combinations (Proposition 1) carry
the sentinel utility U_max, giving players *incomplete preference lists*.
Devices repeatedly propose pairwise swaps; a swap is executed iff it is a
swap-blocking pair (Definition 2: neither involved device's utility rises and
at least one strictly falls).  Termination at a two-sided exchange-stable
matching (Definition 3) is guaranteed because the total utility strictly
decreases with every executed swap and the matching space is finite.

`swap_matching` finds each blocking pair with a vectorized pairwise
utility-delta formulation — the full n x n blocking matrix is evaluated with
numpy broadcasting and the lexicographically first blocking pair is executed
— so the interpreter cost is O(#swaps), not O(rounds * n^2) as in the
textbook triple loop (kept as `swap_matching_loop`, the reference
implementation; both terminate at a 2ES matching and the tests pin their
agreement on total utility).  DESIGN.md §7.
"""
from __future__ import annotations

import dataclasses
import numpy as np

__all__ = [
    "MatchResult",
    "swap_matching",
    "swap_matching_loop",
    "random_assignment",
    "U_MAX",
    "is_two_sided_exchange_stable",
]

U_MAX = 1e30  # sentinel utility for infeasible pairs (eq. 30)


@dataclasses.dataclass(frozen=True)
class MatchResult:
    """assignment[i] = sub-channel of the i-th selected device."""

    assignment: np.ndarray   # (n_sel,) int, channel index per device
    utilities: np.ndarray    # (n_sel,) float, Gamma[assignment[i], i] or U_MAX
    feasible: np.ndarray     # (n_sel,) bool: assigned to a *feasible* channel
    n_swaps: int
    n_rounds: int


def _utilities(gamma_u: np.ndarray, assignment: np.ndarray) -> np.ndarray:
    return gamma_u[assignment, np.arange(assignment.shape[0])]


def prepare_utility(gamma: np.ndarray, feasible: np.ndarray) -> np.ndarray:
    """Eq. (30): U = Gamma where feasible, U_max otherwise."""
    gamma_u = np.where(feasible, gamma, U_MAX)
    # Guard: any non-finite time is treated as infeasible too.
    return np.where(np.isfinite(gamma_u), gamma_u, U_MAX)


def _initial_assignment(rng, initial, k, n_sel):
    if initial is not None:
        return np.asarray(initial, dtype=np.int64).copy()
    rng = np.random.default_rng(0) if rng is None else rng
    return rng.permutation(k)[:n_sel].astype(np.int64)


def swap_matching(
    gamma: np.ndarray,
    feasible: np.ndarray,
    rng: np.random.Generator | None = None,
    *,
    initial: np.ndarray | None = None,
    max_rounds: int = 200,
) -> MatchResult:
    """Run Algorithm 2 (vectorized pairwise utility-delta formulation).

    Each iteration evaluates every candidate swap at once: with the current
    assignment, A[i, j] = U[channel_of(i), j] is the utility device j would
    get from device i's channel, so the Definition-2 blocking condition for
    the ordered pair (n, n2) is

        A.T <= u[:, None]  &  A <= u[None, :]  &  (one strict)

    evaluated as three broadcast comparisons.  The scan cursor replicates the
    reference proposal order of `swap_matching_loop` exactly — the first
    blocking pair at or after the cursor is executed and the cursor advances
    past it, wrapping into a new round like the reference's nested loops —
    so both implementations terminate at the *same* 2ES matching.  The
    Python interpreter does O(1) work per executed swap (plus one per round)
    instead of O(n^2) per scan.

    Args:
      gamma:    (K, n_sel) minimum-time matrix from Algorithm 1.
      feasible: (K, n_sel) Proposition-1 mask.
      rng:      used only for the random initial matching (paper line 2).
      initial:  optional explicit initial assignment (for tests).
      max_rounds: bound on full proposal rounds (same meaning as the
        reference; a generous convergence guard, not a tuning knob).
    """
    k, n_sel = gamma.shape
    if n_sel > k:
        raise ValueError(f"cannot match {n_sel} devices to {k} sub-channels")
    gamma_u = prepare_utility(gamma, feasible)
    assignment = _initial_assignment(rng, initial, k, n_sel)

    n_swaps = 0
    n_rounds = 0
    cursor = 0                       # flat (n, n2) scan position, row-major
    swapped_this_round = False
    dev = np.arange(n_sel)
    nn = n_sel * n_sel
    while n_rounds < max_rounds:
        u = gamma_u[assignment, dev]                 # (n_sel,)
        a = gamma_u[assignment]                      # A[i, j] = U[ch_i, j]
        no_worse_n = a.T <= u[:, None]               # device n on n2's channel
        no_worse_n2 = a <= u[None, :]                # device n2 on n's channel
        strict = (a.T < u[:, None]) | (a < u[None, :])
        blocking = no_worse_n & no_worse_n2 & strict
        np.fill_diagonal(blocking, False)
        ahead = np.flatnonzero(blocking.ravel()[cursor:])
        if ahead.size:
            q = cursor + int(ahead[0])
            n, n2 = divmod(q, n_sel)
            assignment[n], assignment[n2] = assignment[n2], assignment[n]
            n_swaps += 1
            swapped_this_round = True
            cursor = q + 1
            if cursor < nn:
                continue
        # Reached the end of a full proposal round.
        n_rounds += 1
        if not swapped_this_round:   # full round without a blocking pair
            break
        cursor = 0
        swapped_this_round = False
    utils = _utilities(gamma_u, assignment)
    return MatchResult(
        assignment=assignment,
        utilities=utils,
        feasible=utils < U_MAX,
        n_swaps=n_swaps,
        n_rounds=n_rounds,
    )


def swap_matching_loop(
    gamma: np.ndarray,
    feasible: np.ndarray,
    rng: np.random.Generator | None = None,
    *,
    initial: np.ndarray | None = None,
    max_rounds: int = 200,
) -> MatchResult:
    """Reference Algorithm 2: the paper's literal proposal loop (kept for
    equivalence tests against the vectorized `swap_matching`)."""
    k, n_sel = gamma.shape
    if n_sel > k:
        raise ValueError(f"cannot match {n_sel} devices to {k} sub-channels")
    gamma_u = prepare_utility(gamma, feasible)
    assignment = _initial_assignment(rng, initial, k, n_sel)

    n_swaps = 0
    rnd = -1                             # stays -1 when max_rounds == 0
    for rnd in range(max_rounds):
        swapped_this_round = False
        for n in range(n_sel):           # active device (paper line 4)
            for n2 in range(n_sel):      # proposal target (paper line 5)
                if n2 == n:
                    continue
                ch_n, ch_n2 = assignment[n], assignment[n2]
                u_n, u_n2 = gamma_u[ch_n, n], gamma_u[ch_n2, n2]
                u_n_new, u_n2_new = gamma_u[ch_n2, n], gamma_u[ch_n, n2]
                # Definition 2: swap-blocking pair.
                if (
                    u_n_new <= u_n
                    and u_n2_new <= u_n2
                    and (u_n_new < u_n or u_n2_new < u_n2)
                ):
                    assignment[n], assignment[n2] = ch_n2, ch_n
                    n_swaps += 1
                    swapped_this_round = True
        if not swapped_this_round:       # full round without a blocking pair
            break
    utils = _utilities(gamma_u, assignment)
    return MatchResult(
        assignment=assignment,
        utilities=utils,
        feasible=utils < U_MAX,
        n_swaps=n_swaps,
        n_rounds=rnd + 1,
    )


def is_two_sided_exchange_stable(gamma_u: np.ndarray, assignment: np.ndarray) -> bool:
    """Definition 3 checker (used by property tests): no swap-blocking pair."""
    n_sel = assignment.shape[0]
    for n in range(n_sel):
        for n2 in range(n_sel):
            if n2 == n:
                continue
            u_n = gamma_u[assignment[n], n]
            u_n2 = gamma_u[assignment[n2], n2]
            u_n_new = gamma_u[assignment[n2], n]
            u_n2_new = gamma_u[assignment[n], n2]
            if u_n_new <= u_n and u_n2_new <= u_n2 and (u_n_new < u_n or u_n2_new < u_n2):
                return False
    return True


def random_assignment(
    gamma: np.ndarray,
    feasible: np.ndarray,
    rng: np.random.Generator,
    *,
    perm: np.ndarray | None = None,
) -> MatchResult:
    """R-SA baseline (Sec. VI): a uniformly random one-to-one assignment.

    `perm` optionally injects the K-permutation instead of drawing it from
    `rng` — the scan engine pre-samples per-round permutations so both
    engines consume one stream (DESIGN.md §8).
    """
    k, n_sel = gamma.shape
    gamma_u = prepare_utility(gamma, feasible)
    if perm is None:
        perm = rng.permutation(k)
    assignment = np.asarray(perm)[:n_sel].astype(np.int64)
    utils = _utilities(gamma_u, assignment)
    return MatchResult(
        assignment=assignment,
        utilities=utils,
        feasible=utils < U_MAX,
        n_swaps=0,
        n_rounds=0,
    )
