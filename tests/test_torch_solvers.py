"""The port's Algorithm-1 drivers and wireless closed forms against the JAX
package.

`solve_pairs_step` (plain bisection and the K2 wrapper) and
`solve_pairs_fused` (the K1 wrapper) on the CPU against
`solve_pairs_jit(backend="bisect")`, on every `RAResult` field, with the
iteration counts exact; the NumPy copies (`solve_pairs`, `fixed_ra`, the
numpy branch of `wireless` / `feasibility`) bit-identical to the originals.
"""
from _torch_oracle import rel_err  # noqa: I001  (alias first)

import numpy as np
import pytest
import torch

from repro.core import WirelessConfig as JaxConfig
from repro.core import feasibility as jax_feas
from repro.core import fixed_ra as jax_fixed_ra
from repro.core import solve_pairs as jax_solve_pairs
from repro.core import solve_pairs_jit
from repro.core import wireless as jax_wireless
from repro_torch.core import WirelessConfig, fixed_ra, solve_pairs
from repro_torch.core import feasibility, wireless
from repro_torch.core.monotonic_torch import solve_pairs_fused, solve_pairs_step

FIELDS = ("tau", "p", "time_s", "energy_j")


def _horizon(seed=3, rounds=3, k=4, n=40, scale=3.0):
    """A (rounds, K, N) channel horizon with per-element budgets."""
    rng = np.random.default_rng(seed)
    h2 = rng.exponential(size=(rounds, k, n)) * scale
    beta = rng.integers(5, 60, n).astype(np.float64)
    e_max = 0.02 * (0.5 + rng.uniform(size=(rounds, 1, n)))
    return beta[None, None, :], h2, np.broadcast_to(e_max, h2.shape)


def _assert_same_solution(got, want, rtol):
    np.testing.assert_array_equal(got.feasible, want.feasible)
    np.testing.assert_array_equal(got.iterations, want.iterations)
    f = want.feasible
    assert f.any() and (~f).any()
    for field in FIELDS:
        assert rel_err(getattr(got, field)[f], getattr(want, field)[f]) < rtol, field
    assert np.all(np.isinf(got.time_s[~f])) and np.all(np.isnan(got.tau[~f]))


@pytest.mark.parametrize("driver,backend", [("step", "bisect"), ("step", "cuda"),
                                            ("fused", None)])
def test_drivers_match_jit_bisect(driver, backend):
    """float64 on the CPU: iterations exact; values within 1e-12 relative
    (the last ulp of log1p differs between torch and XLA and can move a
    bisection root by a few ulps)."""
    beta, h2, e_max = _horizon()
    want = solve_pairs_jit(beta, h2, JaxConfig(), e_max, backend="bisect")
    if driver == "step":
        got = solve_pairs_step(beta, h2, WirelessConfig(), e_max,
                               backend=backend, device="cpu")
    else:
        got = solve_pairs_fused(beta, h2, WirelessConfig(), e_max, device="cpu")
    _assert_same_solution(got, want, 1e-12)


def test_fused_and_step_drivers_agree_exactly():
    """On the CPU both drivers run the same plain float64 arithmetic."""
    beta, h2, e_max = _horizon(seed=4)
    a = solve_pairs_fused(beta, h2, WirelessConfig(), e_max, device="cpu")
    b = solve_pairs_step(beta, h2, WirelessConfig(), e_max, device="cpu")
    for field in FIELDS + ("feasible", "iterations"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_drivers_with_no_feasible_pair():
    h2 = np.full((2, 3), 1e-9)
    for solve in (solve_pairs_fused, solve_pairs_step):
        ra = solve(np.full(3, 20.0), h2, WirelessConfig(), device="cpu")
        assert not ra.feasible.any() and np.all(np.isinf(ra.time_s))
        assert ra.iterations.shape == (2, 3) and not ra.iterations.any()


def test_drivers_reject_unknown_backend_and_device():
    beta, h2, e_max = _horizon(rounds=1, n=4)
    with pytest.raises(ValueError):
        solve_pairs_step(beta, h2, WirelessConfig(), e_max, backend="newton",
                         device="cpu")
    with pytest.raises(ValueError):
        solve_pairs_fused(beta, h2, WirelessConfig(), e_max, device="meta")


def test_host_solve_pairs_copy_is_bit_identical():
    beta, h2, e_max = _horizon(seed=5, rounds=1)
    a = solve_pairs(beta[0], h2[0], WirelessConfig(), e_max[0])
    b = jax_solve_pairs(beta[0], h2[0], JaxConfig(), e_max[0])
    for field in FIELDS + ("feasible", "iterations"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_fixed_ra_copy_is_bit_identical():
    beta, h2, e_max = _horizon(seed=6)
    a = fixed_ra(beta, h2, WirelessConfig(), e_max)
    b = jax_fixed_ra(beta, h2, JaxConfig(), e_max)
    for field in FIELDS + ("feasible", "iterations"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


_CLOSED_FORMS = ["compute_time", "compute_energy", "comm_rate", "comm_time",
                 "comm_energy", "total_time", "total_energy"]


def _closed_form_args(name, rng, n=500):
    tau, p = rng.uniform(1e-6, 1, n), rng.uniform(1e-6, 1, n)
    beta, h2 = rng.integers(1, 80, n).astype(float), rng.exponential(size=n) * 5
    return {"compute_time": (tau, beta), "compute_energy": (tau, beta),
            "comm_rate": (p, h2), "comm_time": (p, h2), "comm_energy": (p, h2),
            "total_time": (tau, p, beta, h2),
            "total_energy": (tau, p, beta, h2)}[name]


@pytest.mark.parametrize("name", _CLOSED_FORMS)
def test_wireless_closed_forms(name):
    """numpy branch bit-identical to the JAX package's; torch float64 branch
    within 1e-15 relative of it (only log1p may differ, by an ulp)."""
    args = _closed_form_args(name, np.random.default_rng(7))
    want = getattr(jax_wireless, name)(*args, JaxConfig())
    np.testing.assert_array_equal(getattr(wireless, name)(*args, WirelessConfig()), want)
    got = getattr(wireless, name)(*(torch.from_numpy(a) for a in args), WirelessConfig())
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    assert rel_err(got.numpy(), want) < 1e-15


def test_feasibility_copy():
    rng = np.random.default_rng(8)
    h2 = rng.exponential(size=(4, 50)) * 0.5
    e_max = rng.uniform(0.005, 0.05, (4, 50))
    want = jax_feas.is_infeasible(h2, JaxConfig(), e_max)
    assert want.any() and (~want).any()
    np.testing.assert_array_equal(feasibility.is_infeasible(h2, WirelessConfig(), e_max), want)
    got = feasibility.is_infeasible(torch.from_numpy(h2), WirelessConfig(),
                                    torch.from_numpy(e_max))
    np.testing.assert_array_equal(got.numpy(), want)
