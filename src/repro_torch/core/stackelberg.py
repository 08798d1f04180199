"""Stackelberg-game round orchestration (paper Sec. III + Definition 1).

Each communication round:
  follower substrate : Algorithm 1 (MO-RA) evaluates the minimum-time matrix
                       Gamma over all (sub-channel, device) pairs + the
                       Proposition-1 feasibility mask;
  leader             : Algorithm 3 selects devices by AoU x data-size
                       priority, *predicting* the follower's matching;
  follower           : Algorithm 2 (M-SA) fixes the final assignment;
  bookkeeping        : per-round latency (eq. 9), energies, AoU update (eq. 6).

The leader/follower pair returned by `plan_round` is a Stackelberg
equilibrium in the sense of Definition 1: the leader's set maximizes the
weighted participation objective (eq. 42) given the follower's best response,
and the follower's (psi, tau, p) minimize latency given the leader's set.

Benchmark schemes of Sec. VI are selected via `RoundPolicy`:
  ds in {"alg3", "aou_topk", "random", "cluster", "fixed"}
  ra in {"mo", "fix"}          (Algorithm 1 vs tau=p=0.5)
  sa in {"matching", "random"} (Algorithm 2 vs uniform random)
"""
from __future__ import annotations

import dataclasses
import numpy as np

from .aou import AoUState, step_aou
from .monotonic import RAResult, fixed_ra, solve_pairs
from .selection import (
    SelectionOutcome,
    select_aou_alg3,
    select_cluster,
    select_fixed,
    select_random,
    select_topk,
)
from .wireless import WirelessConfig

__all__ = ["RoundPolicy", "RoundPlan", "RoundRandomness", "plan_round",
           "make_clusters", "policy_grid", "DS_SCHEMES", "RA_SCHEMES",
           "SA_SCHEMES", "PAPER_BASELINE_DS"]

# The scheme axes of Sec. VI (RoundPolicy validates against these).
DS_SCHEMES = ("alg3", "aou_topk", "random", "cluster", "fixed")
RA_SCHEMES = ("mo", "fix")
SA_SCHEMES = ("matching", "random")
# The paper's headline comparison (Fig. 3): the proposed Algorithm 3 vs the
# Sec.-VI device-selection baselines.
PAPER_BASELINE_DS = ("alg3", "random", "fixed", "cluster")


@dataclasses.dataclass(frozen=True)
class RoundRandomness:
    """Pre-sampled per-round permutations, injected in place of `rng` draws.

    `fl.sim` samples one of these per round up front so the host loop and
    every engine consume the identical randomness
    stream and the differential harness can pin exact equivalence
    (DESIGN.md §8).  Within an Algorithm-3 replacement loop the single
    `assign_perm` seeds every iteration's initial matching — a documented
    deviation from the legacy per-iteration `rng` draw.
    """

    sel_perm: np.ndarray     # (N,) device permutation (random DS)
    assign_perm: np.ndarray  # (K,) channel permutation (matching init / R-SA)


@dataclasses.dataclass(frozen=True)
class RoundPolicy:
    """One Sec.-VI scheme combination: device selection x resource
    allocation x sub-channel assignment (see module docstring for the
    axes; `policy_grid` builds Cartesian grids of these)."""

    ds: str = "alg3"        # device selection scheme
    ra: str = "mo"          # resource allocation scheme
    sa: str = "matching"    # sub-channel assignment scheme

    def __post_init__(self):
        if self.ds not in DS_SCHEMES:
            raise ValueError(f"unknown ds: {self.ds}")
        if self.ra not in RA_SCHEMES:
            raise ValueError(f"unknown ra: {self.ra}")
        if self.sa not in SA_SCHEMES:
            raise ValueError(f"unknown sa: {self.sa}")

    @property
    def label(self) -> str:
        ds = {"alg3": "Proposed(Alg3)", "aou_topk": "AoU-DS", "random": "Random-DS",
              "cluster": "Cluster-DS", "fixed": "Fixed-DS"}[self.ds]
        return f"{ds}+{'MO-RA' if self.ra == 'mo' else 'FIX-RA'}+" + (
            "M-SA" if self.sa == "matching" else "R-SA")


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """Everything the learning plane needs for one round."""

    selected: np.ndarray       # (N,) bool S_n
    transmitted: np.ndarray    # (N,) bool S_n * sum_k psi_kn (feasible uplink)
    channel_of: np.ndarray     # (N,) int, sub-channel or -1
    tau: np.ndarray            # (N,) tau_{k,n} on the assigned channel (nan if none)
    p: np.ndarray              # (N,) power fraction (nan if none)
    time_per_device: np.ndarray  # (N,) T_{k,n}, inf where not transmitting
    energy_per_device: np.ndarray  # (N,) joules spent (0 where not transmitting)
    latency_s: float           # eq. (9): max over transmitting devices (0 if none)
    aou_next: AoUState         # AoU state after eq. (6) update
    outcome: SelectionOutcome
    gamma: np.ndarray          # (K, N) min-time matrix (Algorithm 1 output)
    feasible: np.ndarray       # (K, N) Proposition-1 mask


def policy_grid(
    ds: str | tuple[str, ...] = ("alg3",),
    ra: str | tuple[str, ...] = ("mo",),
    sa: str | tuple[str, ...] = ("matching",),
) -> list[RoundPolicy]:
    """Cartesian grid of `RoundPolicy` over the Sec.-VI scheme axes.

    Axes accept a single scheme name or a tuple of names; the grid is
    ds-major, then ra, then sa — the ordering the sweep harness
    (`repro.experiments`) uses for stable cell ids.  Each policy is
    validated by `RoundPolicy.__post_init__`.

    >>> [p.ds for p in policy_grid(ds=("alg3", "random"))]
    ['alg3', 'random']
    """
    ds_t = (ds,) if isinstance(ds, str) else tuple(ds)
    ra_t = (ra,) if isinstance(ra, str) else tuple(ra)
    sa_t = (sa,) if isinstance(sa, str) else tuple(sa)
    return [RoundPolicy(ds=d, ra=r, sa=s)
            for d in ds_t for r in ra_t for s in sa_t]


def make_clusters(n_devices: int, k: int, rng: np.random.Generator) -> np.ndarray:
    """Random partition into ceil(N/K) clusters of size <= K (Sec. VI)."""
    n_clusters = int(np.ceil(n_devices / k))
    ids = rng.permutation(n_devices)
    clusters = np.zeros(n_devices, dtype=np.int64)
    for c in range(n_clusters):
        clusters[ids[c * k : (c + 1) * k]] = c
    return clusters


def plan_round(
    aou: AoUState,
    beta: np.ndarray,
    h2: np.ndarray,
    cfg: WirelessConfig,
    rng: np.random.Generator,
    *,
    policy: RoundPolicy = RoundPolicy(),
    round_idx: int = 0,
    clusters: np.ndarray | None = None,
    fixed_ids: np.ndarray | None = None,
    e_max: np.ndarray | float | None = None,
    ra: RAResult | None = None,
    randomness: RoundRandomness | None = None,
) -> RoundPlan:
    """Solve one Stackelberg round. h2 is the (K, N) channel realization.

    `ra` optionally supplies this round's precomputed Algorithm-1 solution
    (fields shaped (K, N)).  Γ is selection-independent, so the whole-horizon
    batch solver (`monotonic_torch.solve_pairs_fused`) can solve every round
    before the training loop and `fl.sim` passes per-round slices here.
    `randomness` optionally injects this round's pre-sampled permutations
    in place of `rng` draws (scan-engine stream sharing, DESIGN.md §8).
    """
    k, n = h2.shape
    beta = np.asarray(beta, np.float64)

    # ---- follower substrate: Algorithm 1 over ALL pairs (leader predicts
    # the follower from the same Gamma; values are selection-independent). --
    if ra is None:
        if policy.ra == "mo":
            ra = solve_pairs(beta[None, :], h2, cfg, e_max)
        else:
            ra = fixed_ra(beta[None, :], h2, cfg, e_max)
    gamma, feas = ra.time_s, ra.feasible

    # ---- leader: device selection (Algorithm 3 or a benchmark scheme). ----
    # Eq. (43) ranks by alpha_n * beta_n; the eq. (7) normalizer sum_i A_i
    # is a positive constant across n, so ranking raw ages is equivalent —
    # and keeps integer-exact products, so `priority_list`'s documented
    # by-id tie-break really happens (dividing first leaks float rounding
    # noise into exact ties, silently reordering them).
    alpha = aou.age.astype(np.float64)
    sel_perm = None if randomness is None else randomness.sel_perm
    assign_perm = None if randomness is None else randomness.assign_perm
    if policy.ds == "alg3":
        out = select_aou_alg3(alpha, beta, gamma, feas, rng, sa=policy.sa,
                              assign_perm=assign_perm)
    elif policy.ds == "aou_topk":
        out = select_topk(alpha, beta, gamma, feas, rng, sa=policy.sa,
                          assign_perm=assign_perm)
    elif policy.ds == "random":
        out = select_random(gamma, feas, rng, sa=policy.sa,
                            sel_perm=sel_perm, assign_perm=assign_perm)
    elif policy.ds == "cluster":
        if clusters is None:
            raise ValueError("cluster DS needs `clusters`")
        out = select_cluster(gamma, feas, rng, round_idx, clusters,
                             sa=policy.sa, assign_perm=assign_perm)
    else:  # fixed
        if fixed_ids is None:
            raise ValueError("fixed DS needs `fixed_ids`")
        out = select_fixed(gamma, feas, rng, fixed_ids, sa=policy.sa,
                           assign_perm=assign_perm)

    # ---- assemble per-device quantities on the assigned channels. --------
    tau = np.full(n, np.nan)
    p = np.full(n, np.nan)
    t_dev = np.full(n, np.inf)
    e_dev = np.zeros(n)
    tx = out.transmitted
    ids = np.where(tx)[0]
    ch = out.channel_of[ids]
    tau[ids] = ra.tau[ch, ids]
    p[ids] = ra.p[ch, ids]
    t_dev[ids] = ra.time_s[ch, ids]
    e_dev[ids] = ra.energy_j[ch, ids]
    latency = float(t_dev[ids].max()) if ids.size else 0.0

    return RoundPlan(
        selected=out.selected,
        transmitted=tx,
        channel_of=out.channel_of,
        tau=tau,
        p=p,
        time_per_device=t_dev,
        energy_per_device=e_dev,
        latency_s=latency,
        aou_next=step_aou(aou, tx),
        outcome=out,
        gamma=gamma,
        feasible=feas,
    )
