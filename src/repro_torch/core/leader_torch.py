"""Device-resident leader plane: Algorithms 2-3 + AoU on tensors.

The port of the JAX package's `core/leader_jax.py`: the whole per-round
Stackelberg leader step on fixed-shape tensors on one device, for the scan
and async engines (`fl.sim`, `fl.async_loop`):

  * AoU update (eq. 6) — a `where` over the age vector;
  * priority list (eq. 43) — stable argsort of age_n * beta_n in float32
    (integer-exact products; ties break by device id);
  * Algorithm 3 — a loop over a FIXED-SIZE id buffer of S = min(K, N)
    slots: each iteration re-matches the buffer, then the j-th infeasible
    slot takes `order[next_ptr + j]`;
  * Algorithm 2 — a loop over the S x S utility-delta blocking matrix with
    the host implementation's scan-cursor proposal order, so both reach
    the same exchange-stable matching in the same number of steps;
  * the benchmark schemes (top-K / random / cluster / fixed DS, R-SA).

JAX runs both loops as `lax.while_loop`s.  Here the loop state stays on
the device and the host reads one scalar per iteration to decide whether
to go on (Algorithm 2: the first blocking pair at or after the cursor;
Algorithm 3: the number of infeasible slots).  Every such read goes through
`host_int`, which counts them.  Randomness is injected, not drawn: callers
pass the per-round permutations sampled on the host (`sel_perm`,
`assign_perm`).
"""
from __future__ import annotations

import torch

from .matching import U_MAX

__all__ = ["prepare_utility", "step_age", "priority_order", "swap_matching",
           "leader_round", "first_true", "host_int"]


def host_int(x: torch.Tensor) -> int:
    """Copy one scalar of a tensor to the host (a device sync on the card).
    Every host read of the device engines goes through here and is counted
    in `host_int.syncs`."""
    host_int.syncs += 1
    return int(x)


host_int.syncs = 0


def first_true(mask: torch.Tensor, size: int) -> torch.Tensor:
    """The ids of the first `size` True entries of a 1-D mask, ascending,
    with the slots past their count set to 0 — `jnp.nonzero(mask,
    size=size, fill_value=0)` without a host sync."""
    n = mask.shape[0]
    ids = torch.argsort((~mask).to(torch.int32), stable=True)
    if size > n:
        ids = torch.cat([ids, ids.new_zeros(size - n)])
    ids = ids[:size]
    slot = torch.arange(size, device=mask.device)
    return torch.where(slot < mask.sum(), ids, 0)


def prepare_utility(gamma: torch.Tensor, feasible: torch.Tensor) -> torch.Tensor:
    """Eq. (30): U = Gamma where feasible, U_max otherwise."""
    gamma_u = torch.where(feasible, gamma, U_MAX)
    return torch.where(torch.isfinite(gamma_u), gamma_u, U_MAX)


def step_age(age: torch.Tensor, transmitted: torch.Tensor) -> torch.Tensor:
    """Eq. (6): transmitted devices reset to 1, everyone else ages by 1."""
    return torch.where(transmitted, 1, age + 1).to(age.dtype)


def priority_order(age: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Eq. (43) order: ids sorted by alpha_n * beta_n descending, ties by id.

    The normaliser of alpha_n (eq. 7) is a positive constant across n, so
    sorting A_n * beta_n gives the same order — and that product is exact
    in float32 for the simulation's integer ages and data sizes (below
    2^24).  The sort is stable, like the host's argsort."""
    prio = age.to(torch.float32) * beta.to(torch.float32)
    return torch.argsort(-prio, stable=True)


def swap_matching(gamma_u: torch.Tensor, valid: torch.Tensor,
                  initial: torch.Tensor, *, max_rounds: int = 200):
    """Algorithm 2 over a fixed S-slot candidate buffer.

    Each iteration evaluates the full S x S Definition-2 blocking matrix,
    executes the first blocking pair at or after the flat row-major cursor,
    and wraps into a new proposal round exactly like the reference nested
    loops.  `valid` masks pad slots out of the blocking matrix.

    Args:
      gamma_u: (K, S) utilities, U_MAX at infeasible/pad entries.
      valid:   (S,) slot-validity mask (real device vs padding).
      initial: (S,) initial channel per slot.

    Returns (assignment (S,) int64, feasible (S,) bool, n_swaps, n_rounds),
    the counts as Python ints.
    """
    s = gamma_u.shape[1]
    nn = s * s
    dev = torch.arange(s, device=gamma_u.device)
    pos = torch.arange(nn, device=gamma_u.device)
    eye = torch.eye(s, dtype=torch.bool, device=gamma_u.device)
    pair_ok = (valid[:, None] & valid[None, :] & ~eye).reshape(-1)

    def blocking(assignment):
        u = gamma_u[assignment, dev]                 # (S,)
        a = gamma_u[assignment]                      # A[i, j] = U[ch_i, j]
        no_worse_n = a.T <= u[:, None]
        no_worse_n2 = a <= u[None, :]
        strict = (a.T < u[:, None]) | (a < u[None, :])
        return (no_worse_n & no_worse_n2 & strict).reshape(-1) & pair_ok

    assignment = initial.to(torch.int64).clone()
    cursor, swapped, n_rounds, n_swaps = 0, False, 0, 0
    done = max_rounds <= 0
    while not done:
        cand = blocking(assignment) & (pos >= cursor)
        # The first blocking pair at or after the cursor, nn when none.
        q = host_int(torch.where(cand.any(), cand.to(torch.int32).argmax(), nn))
        has = q < nn
        if has:
            # Swap by basic indexing with host ints: an index list would be
            # copied to the card, which waits for the queue to drain.
            n1, n2 = divmod(q, s)
            assignment[n1], assignment[n2] = assignment[n2].clone(), assignment[n1].clone()
            n_swaps += 1
            swapped = True
        # End of a full proposal round: scanned past the last pair, or no
        # blocking pair remains ahead of the cursor.
        end = (not has) or q + 1 >= nn
        n_rounds += int(end)
        done = end and (not swapped or n_rounds >= max_rounds)
        cursor = 0 if end else q + 1
        swapped = swapped and not end
    feasible = (gamma_u[assignment, dev] < U_MAX) & valid
    return assignment, feasible, n_swaps, n_rounds


def leader_round(age, beta, gamma, feasible, sel_perm, assign_perm, round_idx,
                 clusters, fixed_ids, *, ds: str, sa: str, k: int, n: int,
                 n_clusters: int = 1, max_rounds: int = 200) -> dict:
    """One leader step (Algorithm 3 or a benchmark DS + Algorithm 2 or R-SA).

    Args (tensors on one device):
      age:         (N,) int AoU ages.
      beta:        (N,) data sizes.
      gamma:       (K, N) minimum-time matrix (Algorithm 1 output).
      feasible:    (K, N) Proposition-1 mask.
      sel_perm:    (N,) injected device permutation (random DS).
      assign_perm: (K,) injected channel permutation (matching init / R-SA).
      round_idx:   round index (cluster rotation), int or scalar tensor.
      clusters:    (N,) cluster id per device; `n_clusters` their count.
      fixed_ids:   (S,) fixed DS ids, S = min(K, N).

    Returns a dict: selected/transmitted (N,) bool, channel_of (N,) int64
    (-1 where unassigned), age_next (N,), iterations (the Algorithm-3 count,
    a Python int).
    """
    s = min(k, n)
    device = gamma.device
    slot = torch.arange(s, device=device)
    gamma_u = prepare_utility(gamma, feasible)
    all_valid = torch.ones(s, dtype=torch.bool, device=device)

    def match(ids, valid):
        """Follower prediction over the candidate buffer."""
        ids_g = torch.where(valid, ids, 0)
        sub = torch.where(valid[None, :], gamma_u[:, ids_g], U_MAX)
        init = assign_perm[:s].to(torch.int64)
        if sa == "matching":
            assignment, feas_m, _, _ = swap_matching(sub, valid, init,
                                                     max_rounds=max_rounds)
        else:  # R-SA: the injected permutation IS the assignment
            assignment = init
            feas_m = (sub[assignment, slot] < U_MAX) & valid
        return assignment, feas_m

    it = 1
    if ds in ("alg3", "aou_topk"):
        order = priority_order(age, beta)

    if ds == "alg3":
        max_iter = n                      # host default: one pass over Q
        ids, next_ptr, it = order[:s], s, 0
        while True:
            assignment, feas_m = match(ids, all_valid)
            it += 1
            unfeas = ~feas_m
            n_unfeas = host_int(unfeas.sum())
            # Paper line 6: stop when every sub-channel carries a
            # transmitting device, or Q is exhausted, or out of iterations.
            if n_unfeas == 0 or next_ptr >= n or it >= max_iter:
                break
            # Lines 9-10: the j-th infeasible slot takes order[next_ptr + j].
            src = next_ptr + torch.cumsum(unfeas.to(torch.int64), 0) - 1
            take = unfeas & (src < n)
            ids = torch.where(take, order[torch.clamp(src, 0, n - 1)], ids)
            next_ptr += min(n_unfeas, n - next_ptr)
        valid = all_valid
    elif ds == "aou_topk":
        ids, valid = order[:s], all_valid
        assignment, feas_m = match(ids, valid)
    elif ds == "random":
        ids, valid = sel_perm[:s].to(torch.int64), all_valid
        assignment, feas_m = match(ids, valid)
    elif ds == "cluster":
        mask = clusters == (round_idx % n_clusters)
        ids = first_true(mask, s)
        valid = slot < mask.sum()
        assignment, feas_m = match(ids, valid)
    elif ds == "fixed":
        ids, valid = fixed_ids.to(torch.int64), all_valid
        assignment, feas_m = match(ids, valid)
    else:
        raise ValueError(f"unknown ds: {ds}")

    # ---- scatter slots back to device-indexed arrays.  Pad slots all land
    # on the sacrificial row n: their writes there are unordered on CUDA
    # (duplicate indices), which is harmless only because row n is sliced
    # away and never read.
    tx_slot = feas_m & valid
    ids_s = torch.where(valid, ids, n)
    # (`index_fill_` takes its value as a scalar argument; `selected[ids_s] =
    # True` would copy a host tensor to the card and wait for the queue.)
    selected = torch.zeros(n + 1, dtype=torch.bool, device=device).index_fill_(0, ids_s, True)
    transmitted = torch.zeros(n + 1, dtype=torch.bool, device=device)
    transmitted[ids_s] = tx_slot
    channel_of = torch.full((n + 1,), -1, dtype=torch.int64, device=device)
    channel_of[ids_s] = torch.where(tx_slot, assignment, -1)
    transmitted = transmitted[:n]

    return {
        "selected": selected[:n],
        "transmitted": transmitted,
        "channel_of": channel_of[:n],
        "age_next": step_age(age, transmitted),
        "iterations": it,
    }
