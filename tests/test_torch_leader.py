"""The port's device leader plane (`repro_torch.core.leader_torch`) against
the JAX package's `repro.core.leader_jax`, on the same numpy-drawn inputs.

Every output is a decision — selected / transmitted sets, the channel of
each device, the next ages, the Algorithm-3 iteration count, Algorithm 2's
swap and round counts — so every comparison is exact.  Both sides rank
float32 age*beta products (integer-exact) with a stable sort and compare
float32 utilities, so ties resolve the same way; the tie cases below draw
equal products on purpose.
"""
from _torch_oracle import enable_x64  # noqa: F401,I001  (alias first)

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import leader_jax
from repro_torch.core import leader_torch

N, K = 12, 4
POLICIES = list(itertools.product(("alg3", "aou_topk", "random", "cluster", "fixed"),
                                  ("matching", "random")))


def _draw(seed: int, *, ties: bool = False, infeasible: float = 0.5) -> dict:
    rng = np.random.default_rng(seed)
    if ties:      # equal age*beta products across many devices
        age = np.ones(N, np.int32) * 2
        beta = np.full(N, 30.0)
        beta[::3] = 15.0
        age[::3] = 4
    else:
        age = rng.integers(1, 8, N).astype(np.int32)
        beta = rng.integers(5, 60, N).astype(np.float64)
    return dict(
        age=age,
        beta=beta.astype(np.float32),
        gamma=(rng.exponential(size=(K, N)) * 5).astype(np.float32),
        feasible=rng.uniform(size=(K, N)) > infeasible,
        sel_perm=rng.permutation(N).astype(np.int32),
        assign_perm=rng.permutation(K).astype(np.int32),
        round_idx=int(rng.integers(0, 10)),
        clusters=(np.arange(N) % 3).astype(np.int32),
        fixed_ids=rng.permutation(N)[:K].astype(np.int32),
    )


def _run_both(inp: dict, ds: str, sa: str):
    kw = dict(ds=ds, sa=sa, k=K, n=N, n_clusters=3)
    want = leader_jax.leader_round(*(jnp.asarray(v) for v in inp.values()), **kw)
    got = leader_torch.leader_round(*(torch.as_tensor(v) for v in inp.values()), **kw)
    return got, want


def _assert_same(got: dict, want: dict):
    for name in ("selected", "transmitted", "channel_of", "age_next"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]),
                                      err_msg=name)
    assert got["iterations"] == int(want["iterations"])


@pytest.mark.parametrize("ds,sa", POLICIES, ids=[f"{d}-{s}" for d, s in POLICIES])
def test_leader_round_matches_jax(ds, sa):
    """Four draws at half the pairs infeasible, and two at 85%, where
    Algorithm 3 runs through the whole priority queue."""
    iters = []
    for seed, infeasible in [(0, 0.5), (1, 0.5), (2, 0.5), (3, 0.5), (4, 0.85), (5, 0.85)]:
        got, want = _run_both(_draw(seed, infeasible=infeasible), ds, sa)
        _assert_same(got, want)
        iters.append(got["iterations"])
    if ds == "alg3":
        assert max(iters) > 2            # the Algorithm-3 refill loop ran


@pytest.mark.parametrize("ds", ["alg3", "aou_topk"])
def test_leader_round_ties_break_by_id(ds):
    inp = _draw(7, ties=True, infeasible=0.3)
    got, want = _run_both(inp, ds, "matching")
    _assert_same(got, want)
    prio = inp["age"].astype(np.float32) * inp["beta"]
    order = leader_torch.priority_order(torch.as_tensor(inp["age"]),
                                        torch.as_tensor(inp["beta"])).numpy()
    np.testing.assert_array_equal(order, np.argsort(-prio, kind="stable"))
    np.testing.assert_array_equal(
        order, np.asarray(leader_jax.priority_order(jnp.asarray(inp["age"]),
                                                    jnp.asarray(inp["beta"]))))


@pytest.mark.parametrize("seed", range(3))
def test_swap_matching_is_cursor_exact(seed):
    """Same assignment, same number of swaps and of proposal rounds."""
    rng = np.random.default_rng(100 + seed)
    s = 6
    gamma_u = np.where(rng.uniform(size=(s, s)) > 0.3,
                       rng.exponential(size=(s, s)) * 5, 1e30).astype(np.float32)
    valid = np.arange(s) < s - seed          # some pad slots
    init = rng.permutation(s).astype(np.int32)
    want = leader_jax.swap_matching_jnp(jnp.asarray(gamma_u), jnp.asarray(valid),
                                        jnp.asarray(init))
    got = leader_torch.swap_matching(torch.as_tensor(gamma_u), torch.as_tensor(valid),
                                     torch.as_tensor(init))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (got[2], got[3]) == (int(want[2]), int(want[3]))
    assert got[2] > 0


@pytest.mark.parametrize("size", [3, 5, 9])
def test_first_true_is_fixed_size_nonzero(size):
    mask = np.array([0, 1, 0, 1, 1, 0, 0], bool)
    want = np.asarray(jnp.nonzero(jnp.asarray(mask), size=size, fill_value=0)[0])
    np.testing.assert_array_equal(
        leader_torch.first_true(torch.as_tensor(mask), size).numpy(), want)


def test_host_reads_are_counted():
    before = leader_torch.host_int.syncs
    got, _ = _run_both(_draw(1), "alg3", "matching")
    assert leader_torch.host_int.syncs - before >= got["iterations"]
    before = leader_torch.host_int.syncs
    _run_both(_draw(1), "fixed", "random")
    assert leader_torch.host_int.syncs == before     # no loop, no read
