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

Every operand has a leading cell axis B (`leader_round_cells`): a group
of cells that share one (ds, sa) policy runs one leader step together, as
the JAX package's `vmap` of `leader_round` does.  `leader_round` is its
one-cell case.

JAX runs both loops as `lax.while_loop`s.  Here the tensors stay on the
device, one row per cell — Algorithm 2's assignment and scan cursor,
Algorithm 3's candidate ids — and each iteration ends in one host read of
a (B,) vector: each cell's first blocking pair (with Algorithm 3, also its
count of infeasible slots).  The host mirrors the rest of the loop state
from it, per cell in Python — the swapped flag, the round and swap counts,
Algorithm 3's queue pointer and iteration count — and stops when no cell
runs; a cell whose loop has ended stays as it is, so a batch iterates as
often as its slowest cell alone.  Algorithm 3 is one flat loop: a cell
whose matching ends at an iteration takes its Algorithm-3 step (re-match or
stop) on that iteration's counts.  Every read goes through `host_ints` (a
vector in one read) or `host_int`, counted in `host_int.syncs`.
Randomness is injected, not drawn: callers pass the per-round
permutations sampled on the host (`sel_perm`, `assign_perm`).
"""
from __future__ import annotations

import functools

import torch

from .matching import U_MAX

__all__ = ["prepare_utility", "step_age", "priority_order", "swap_matching",
           "leader_round", "leader_round_cells", "first_true", "host_int",
           "host_ints"]


def host_int(x: torch.Tensor) -> int:
    """Copy one scalar of a tensor to the host (a device sync on the card).
    Every host read of the device engines goes through here and is counted
    in `host_int.syncs`."""
    host_int.syncs += 1
    return int(x)


host_int.syncs = 0


def host_ints(x: torch.Tensor) -> list[int]:
    """Copy a 1-D tensor to the host as ints: one device sync, counted in
    `host_int.syncs` like a scalar read."""
    host_int.syncs += 1
    return x.tolist()


def first_true(mask: torch.Tensor, size: int) -> torch.Tensor:
    """The ids of the first `size` True entries of a mask along its last
    axis, ascending, with the slots past their count set to 0 —
    `jnp.nonzero(mask, size=size, fill_value=0)` per row, without a host
    sync."""
    n = mask.shape[-1]
    ids = torch.argsort((~mask).to(torch.int32), dim=-1, stable=True)
    if size > n:
        ids = torch.cat([ids, ids.new_zeros(ids.shape[:-1] + (size - n,))], dim=-1)
    ids = ids[..., :size]
    slot = torch.arange(size, device=mask.device)
    return torch.where(slot < mask.sum(-1, keepdim=True), ids, 0)


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
    2^24).  The sort is stable, like the host's argsort; it runs along the
    last axis, one row per cell."""
    prio = age.to(torch.float32) * beta.to(torch.float32)
    return torch.argsort(-prio, dim=-1, stable=True)


def _utility_rows(gamma_u: torch.Tensor, ids: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """(B, K, S) utilities of each cell's candidate buffer: column j is
    device ids[:, j], U_MAX at pad slots."""
    ids_g = torch.where(valid, ids, 0)
    sub = gamma_u.gather(2, ids_g[:, None, :].expand(-1, gamma_u.shape[1], -1))
    return torch.where(valid[:, None, :], sub, U_MAX)


def _own_utility(sub: torch.Tensor, assignment: torch.Tensor) -> torch.Tensor:
    """(B, S): U[ch_i, i], each slot's utility on its assigned channel."""
    return sub.gather(1, assignment[:, None, :])[:, 0]


@functools.cache
def _swap_table(s: int, device: torch.device) -> torch.Tensor:
    """(S*S, S) permutations: row q = i*S + j exchanges slots i and j (row
    0, the pair (0, 0), is the identity)."""
    q = torch.arange(s * s, device=device)[:, None]
    i, j, slot = q // s, q % s, torch.arange(s, device=device)
    return torch.where(slot == i, j, torch.where(slot == j, i, slot))


class _Matching:
    """Algorithm 2 over a fixed S-slot candidate buffer, one row per cell.

    Each `propose` evaluates every cell's S x S Definition-2 blocking
    matrix and finds the first blocking pair at or after the cell's flat
    row-major cursor, 0 when there is none (position 0 is the pair (0, 0),
    never blocking).  The host reads that (B,) vector, and `advance`
    executes each cell's pair on the device (a row of `_swap_table`; row 0
    leaves the cell as it is) and moves its cursor, and mirrors on the host
    what the reference's nested loops keep — the swapped flag, the round
    and swap counts, whether the cell still runs — so both reach the same
    exchange-stable matching in the same number of steps.  A matching that
    ended with a full proposal round without a swap has no blocking pair
    left, so its cell stays as it is with no mask; one stopped by
    `max_rounds` is frozen by a cursor past the last pair.  `valid` (B, S)
    masks pad slots out of the blocking matrix.  With ``enabled=False``
    (R-SA) nothing runs: the initial assignment is the assignment."""

    def __init__(self, valid: torch.Tensor, initial: torch.Tensor, *,
                 max_rounds: int, enabled: bool = True):
        b, s = valid.shape
        device = valid.device
        self.s, self.nn, self.max_rounds = s, s * s, max_rounds
        self.enabled = enabled and max_rounds > 0
        self.initial = self.assignment = initial
        eye = torch.eye(s, dtype=torch.bool, device=device)
        pair_ok = (valid[:, :, None] & valid[:, None, :] & ~eye).reshape(b, -1)
        self.pos = torch.arange(s * s, device=device)
        self.pair_ok = pair_ok
        self.cursor = torch.zeros(b, dtype=torch.int64, device=device)
        self.frozen: torch.Tensor | None = None     # cells stopped by max_rounds
        self.running = [self.enabled] * b
        self.swapped = [False] * b
        self.n_rounds = [0] * b
        self.n_swaps = [0] * b

    def propose(self, sub: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(q, u): each cell's first blocking pair at or after its cursor (0
        when none) and each slot's utility on its channel, on the device."""
        a = sub.gather(1, self.assignment[:, :, None].expand(-1, -1, self.s))
        u = a.diagonal(dim1=1, dim2=2)                             # U[ch_i, i]
        at = a.transpose(1, 2)                                     # A[i, j] = U[ch_i, j]
        no_worse_n = at <= u[:, :, None]
        no_worse_n2 = a <= u[:, None, :]
        strict = (at < u[:, :, None]) | (a < u[:, None, :])
        ahead = self.pair_ok & (self.pos >= self.cursor[:, None])
        cand = (no_worse_n & no_worse_n2 & strict).reshape(ahead.shape) & ahead
        return cand.to(torch.int32).argmax(-1), u

    def advance(self, q_dev: torch.Tensor, q: list[int]) -> list[int]:
        """Execute the pairs `q_dev` (read on the host as `q`) and step each
        running cell's loop; returns the cells whose matching ended."""
        if any(q):
            self.assignment = self.assignment.gather(1, _swap_table(self.s, q_dev.device)[q_dev])
        # Positions 0 and nn - 1 are the diagonal pairs (0, 0) and
        # (S-1, S-1), which never block: q > 0 is a pair executed, q = 0
        # the end of a proposal round, and the next cursor q + 1 is past the
        # pair, or 1 at a round's start (the same as 0).
        self.cursor = q_dev + 1
        ended = []
        for b, qb in enumerate(q):
            if not self.running[b]:
                continue
            if qb:
                self.n_swaps[b] += 1
                self.swapped[b] = True
                continue
            self.n_rounds[b] += 1
            if not self.swapped[b] or self.n_rounds[b] >= self.max_rounds:
                self.running[b] = False
                ended.append(b)
                if self.swapped[b]:
                    self._freeze(b, True)
            self.swapped[b] = False
        if self.frozen is not None:
            self.cursor = torch.maximum(self.cursor, self.frozen)
        return ended

    def _freeze(self, b: int, on: bool) -> None:
        if self.frozen is None:
            self.frozen = torch.zeros_like(self.cursor)
        self.frozen[b] = self.nn if on else 0

    def restart(self, b: int) -> None:
        """Start cell b's matching afresh from its initial assignment."""
        self.assignment[b] = self.initial[b]
        if self.frozen is not None:
            self._freeze(b, False)
            self.cursor[b] = 0
        self.running[b], self.swapped[b], self.n_rounds[b] = self.enabled, False, 0

    def run(self, sub: torch.Tensor) -> None:
        """Step until no cell runs: one host read per iteration."""
        while any(self.running):
            q_dev, _ = self.propose(sub)
            self.advance(q_dev, host_ints(q_dev))


def swap_matching(gamma_u: torch.Tensor, valid: torch.Tensor,
                  initial: torch.Tensor, *, max_rounds: int = 200):
    """Algorithm 2 over one fixed S-slot candidate buffer (one cell).

    Args:
      gamma_u: (K, S) utilities, U_MAX at infeasible/pad entries.
      valid:   (S,) slot-validity mask (real device vs padding).
      initial: (S,) initial channel per slot.

    Returns (assignment (S,) int64, feasible (S,) bool, n_swaps, n_rounds),
    the counts as Python ints.
    """
    sub, valid = gamma_u[None], valid[None]
    m = _Matching(valid, initial[None].to(torch.int64), max_rounds=max_rounds)
    m.run(sub)
    feasible = (_own_utility(sub, m.assignment) < U_MAX) & valid
    return m.assignment[0], feasible[0], m.n_swaps[0], m.n_rounds[0]


def leader_round_cells(age, beta, gamma, feasible, sel_perm, assign_perm, round_idx,
                       clusters, fixed_ids, *, ds: str, sa: str, k: int, n: int,
                       n_clusters: int = 1, max_rounds: int = 200) -> dict:
    """One leader step (Algorithm 3 or a benchmark DS + Algorithm 2 or R-SA)
    of B cells that share one (ds, sa) policy.

    Args (tensors on one device, each with a leading cell axis B):
      age:         (B, N) int AoU ages.
      beta:        (B, N) data sizes.
      gamma:       (B, K, N) minimum-time matrix (Algorithm 1 output).
      feasible:    (B, K, N) Proposition-1 mask.
      sel_perm:    (B, N) injected device permutation (random DS).
      assign_perm: (B, K) injected channel permutation (matching init / R-SA).
      round_idx:   round index (cluster rotation), int or scalar tensor.
      clusters:    (B, N) cluster id per device; `n_clusters` their count.
      fixed_ids:   (B, S) fixed DS ids, S = min(K, N).

    Returns a dict: selected/transmitted (B, N) bool, channel_of (B, N)
    int64 (-1 where unassigned), age_next (B, N), and iterations, the
    Algorithm-3 count of each cell as a list of Python ints (1 for the
    other policies).  Each cell's rows are the ones it gets alone.
    """
    b = age.shape[0]
    s = min(k, n)
    device = gamma.device
    slot = torch.arange(s, device=device)
    gamma_u = prepare_utility(gamma, feasible)
    valid = torch.ones((b, s), dtype=torch.bool, device=device)
    if ds in ("alg3", "aou_topk"):
        order = priority_order(age, beta)
        ids = order[:, :s]
    elif ds == "random":
        ids = sel_perm[:, :s].to(torch.int64)
    elif ds == "cluster":
        mask = clusters == (round_idx % n_clusters)
        ids = first_true(mask, s)
        valid = slot < mask.sum(-1, keepdim=True)
    elif ds == "fixed":
        ids = fixed_ids.to(torch.int64)
    else:
        raise ValueError(f"unknown ds: {ds}")
    # Follower prediction over the candidate buffer: Algorithm 2, or R-SA
    # (the injected permutation IS the assignment).
    m = _Matching(valid, assign_perm[:, :s].to(torch.int64), max_rounds=max_rounds,
                  enabled=sa == "matching")
    sub = _utility_rows(gamma_u, ids, valid)
    iterations = [1] * b

    if ds == "alg3":
        ids, sub = _algorithm3(m, gamma_u, order, ids, sub, iterations, n=n)
    else:
        m.run(sub)
    assignment = m.assignment
    feas_m = (_own_utility(sub, assignment) < U_MAX) & valid

    # ---- scatter slots back to device-indexed arrays.  Pad slots all land
    # on the sacrificial column n: their writes there are unordered on CUDA
    # (duplicate indices), which is harmless only because column n is
    # sliced away and never read.
    tx_slot = feas_m & valid
    ids_s = torch.where(valid, ids, n)
    # (`scatter_` takes its value as a scalar argument; `selected[ids_s] =
    # True` would copy a host tensor to the card and wait for the queue.)
    selected = torch.zeros((b, n + 1), dtype=torch.bool, device=device).scatter_(1, ids_s, True)
    transmitted = torch.zeros((b, n + 1), dtype=torch.bool, device=device).scatter_(
        1, ids_s, tx_slot)[:, :n]
    channel_of = torch.full((b, n + 1), -1, dtype=torch.int64, device=device).scatter_(
        1, ids_s, torch.where(tx_slot, assignment, -1))

    return {
        "selected": selected[:, :n],
        "transmitted": transmitted,
        "channel_of": channel_of[:, :n],
        "age_next": step_age(age, transmitted),
        "iterations": iterations,
    }


def _algorithm3(m: _Matching, gamma_u, order, ids, sub, iterations: list[int], *,
                n: int):
    """Algorithm 3's loop for every cell of `m`: each iteration re-matches
    the S-slot buffer, then the j-th infeasible slot takes
    `order[next_ptr + j]`.  One flat loop: every step makes one Algorithm-2
    step of each running cell and reads, with its pairs, each cell's count
    of infeasible slots; a cell whose matching ended at that step takes its
    Algorithm-3 step at once — stop, or refill and re-match from the next
    step.  A matching ends only at a step with no pair to execute (a cell
    stopped by `max_rounds` is frozen on that same step), so that step's
    counts are those of its final assignment.  With R-SA every step is an
    Algorithm-3 step.  Returns the final (ids, sub); `iterations` is filled
    in place."""
    b, s = ids.shape
    max_iter = n                          # host default: one pass over Q
    ids = ids.clone()
    next_ptr, alive = [s] * b, [True] * b
    iterations[:] = [0] * b
    while any(alive):
        if m.enabled:
            q_dev, u = m.propose(sub)
        else:
            u = _own_utility(sub, m.assignment)
        unfeas = ~(u < U_MAX)
        counts = unfeas.sum(-1)
        if m.enabled:
            read = host_ints(torch.stack([q_dev, counts]).reshape(-1))
            q, n_unfeas = read[:b], read[b:]
            ended = m.advance(q_dev, q)
        else:
            n_unfeas, ended = host_ints(counts), []
        refilled = False
        for c in range(b):
            if not alive[c] or (m.enabled and c not in ended):
                continue
            iterations[c] += 1
            # Paper line 6: stop when every sub-channel carries a
            # transmitting device, or Q is exhausted, or out of iterations.
            if n_unfeas[c] == 0 or next_ptr[c] >= n or iterations[c] >= max_iter:
                alive[c] = False
                continue
            # Lines 9-10: the j-th infeasible slot takes order[next_ptr + j].
            src = torch.cumsum(unfeas[c], 0) + (next_ptr[c] - 1)
            take = unfeas[c] & (src < n)
            ids[c] = torch.where(take, order[c][torch.clamp(src, 0, n - 1)], ids[c])
            next_ptr[c] += min(n_unfeas[c], n - next_ptr[c])
            m.restart(c)
            refilled = True
        if refilled:
            sub = _utility_rows(gamma_u, ids, torch.ones_like(ids, dtype=torch.bool))
    return ids, sub


def leader_round(age, beta, gamma, feasible, sel_perm, assign_perm, round_idx,
                 clusters, fixed_ids, **kw) -> dict:
    """One cell's leader step: `leader_round_cells` on a batch of one, the
    operands without the cell axis ((N,) age, (K, N) gamma, ...) and so the
    results ((N,) masks, a scalar iteration count)."""
    out = leader_round_cells(age[None], beta[None], gamma[None], feasible[None],
                             sel_perm[None], assign_perm[None], round_idx,
                             clusters[None], fixed_ids[None], **kw)
    return {name: v[0] for name, v in out.items()}
