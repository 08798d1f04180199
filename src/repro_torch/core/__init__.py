"""Paper core, PyTorch port: the control plane of the Stackelberg game.

  wireless         -- system model, eqs. 1-10 (numpy/torch backend-agnostic)
  feasibility      -- Proposition 1
  monotonic        -- Algorithm 1, host NumPy reference (copy)
  monotonic_torch  -- Algorithm 1 batched on the card (kernels K1 and K2,
                      or the plain "bisect" / "newton" / "mixed"
                      projections) and `precompute_gamma`; import it as
                      `repro_torch.core.monotonic_torch` (the kernels
                      import this package's wireless model)
  matching         -- Algorithm 2 (swap matching), NumPy copy
  aou              -- Age-of-Update state, eqs. 6-7, NumPy copy
  convergence      -- Proposition 3's bound (eq. 40), NumPy copy
  selection        -- Algorithm 3 + benchmark schemes, NumPy copy
  stackelberg      -- per-round game orchestration, NumPy copy
  leader_torch     -- the per-round leader (AoU, Algorithms 2-3) on tensors
                      for the device engines; import it as
                      `repro_torch.core.leader_torch`
"""
from .aou import AoUState, aou_weights, init_aou, step_aou
from .convergence import convergence_bound, participation_deficit
from .feasibility import feasible_mask, is_infeasible, min_comm_energy
from .matching import U_MAX, MatchResult, random_assignment, swap_matching
from .monotonic import RAResult, fixed_ra, solve_pairs
from .selection import (SelectionOutcome, priority_list, select_aou_alg3,
                        select_cluster, select_fixed, select_random,
                        select_topk)
from .stackelberg import (DS_SCHEMES, PAPER_BASELINE_DS, RA_SCHEMES,
                          SA_SCHEMES, RoundPlan, RoundPolicy, RoundRandomness,
                          make_clusters, plan_round, policy_grid)
from .wireless import (WirelessConfig, comm_energy, comm_rate, comm_time,
                       compute_energy, compute_time, total_energy, total_time)

__all__ = [
    "AoUState", "init_aou", "step_aou", "aou_weights",
    "convergence_bound", "participation_deficit",
    "feasible_mask", "is_infeasible", "min_comm_energy",
    "U_MAX", "MatchResult", "swap_matching", "random_assignment",
    "RAResult", "solve_pairs", "fixed_ra",
    "SelectionOutcome", "priority_list", "select_aou_alg3", "select_topk",
    "select_random", "select_cluster", "select_fixed",
    "RoundPolicy", "RoundPlan", "RoundRandomness", "plan_round",
    "make_clusters", "policy_grid", "DS_SCHEMES", "RA_SCHEMES", "SA_SCHEMES",
    "PAPER_BASELINE_DS",
    "WirelessConfig", "comm_rate", "comm_time", "comm_energy",
    "compute_time", "compute_energy", "total_time", "total_energy",
]
