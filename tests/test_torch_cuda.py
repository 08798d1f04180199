"""The port's CUDA kernels against their plain torch versions, on the card.

Needs an NVIDIA GPU with nvcc (the kernels build on first use); every test
here is marked `cuda` and skips where torch sees no CUDA device.  This file
imports no JAX, so it runs on a GPU machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import WirelessConfig, is_infeasible
from repro_torch.core.monotonic_torch import solve_pairs_fused, solve_pairs_step
from repro_torch.fl import SimConfig, run_simulation
from repro_torch.kernels.fedavg_agg import (fedavg_agg_plain, fedavg_aggregate,
                                            fedavg_aggregate_tree)
from repro_torch.kernels.polyblock_fused.ops import (polyblock_solve_fused,
                                                     polyblock_solve_plain)
from repro_torch.kernels.polyblock_project.ops import (polyblock_project,
                                                       project_bisect)

pytestmark = pytest.mark.cuda
CFG = WirelessConfig()
DTYPES = [torch.float64, torch.float32]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


def _pairs(n=2000, seed=0, dev=None, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    h2 = rng.exponential(size=n) * 3
    beta = rng.integers(5, 60, n).astype(np.float64)
    keep = ~is_infeasible(h2, CFG, np.full(n, CFG.e_max_j))
    t = lambda x: torch.as_tensor(x[keep], dtype=dtype, device=dev)
    return t(beta), t(h2), t(np.full(n, CFG.e_max_j))


@pytest.mark.parametrize("dtype", DTYPES)
def test_project_kernel_matches_plain(dev, dtype):
    beta, h2, e = _pairs(dev=dev, dtype=dtype)
    v = torch.rand(beta.shape[0], 2, dtype=dtype, device=dev,
                   generator=torch.Generator(dev).manual_seed(1)) * 0.95 + 0.05
    before = polyblock_project.launches
    got = polyblock_project(v, beta, h2, e, CFG)
    torch.cuda.synchronize()
    assert polyblock_project.launches == before + 1
    want = project_bisect(v, beta, h2, e, CFG)
    # float64: only log1p's last ulp and torch's reciprocal-multiply division
    # by a scalar differ; float32 roots are resolved to ~1e-5 (g's noise).
    limit = 1e-10 if dtype == torch.float64 else 1e-4
    assert ((got - want).abs() / want.abs()).max().item() < limit


@pytest.mark.parametrize("dtype", DTYPES)
def test_solve_kernel_matches_plain(dev, dtype):
    """The fp32-study contract for both types: > 97% of pairs on the same
    trajectory, close there, and |dT| <= eps on the rest."""
    args = _pairs(dev=dev, dtype=dtype)
    before = polyblock_solve_fused.launches
    got = polyblock_solve_fused(*args, CFG)
    torch.cuda.synchronize()
    assert polyblock_solve_fused.launches == before + 1
    want = polyblock_solve_plain(*args, CFG)
    same = got[3] == want[3]
    assert same.double().mean().item() > 0.97
    limit = 1e-9 if dtype == torch.float64 else 1e-4
    for g, w in zip(got[:3], want[:3]):
        assert ((g[same] - w[same]).abs() / w[same].abs()).max().item() < limit
    assert ((got[2][~same] - want[2][~same]).abs() <= 0.01 + 1e-6).all()


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    beta, h2, e = _pairs(n=64, dev=dev)
    v = torch.ones(beta.shape[0], 2, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        polyblock_project(v.half(), beta, h2, e, CFG)
    with pytest.raises(ValueError):
        polyblock_project(v, beta.float(), h2, e, CFG)
    with pytest.raises(ValueError):
        polyblock_project(v, beta[:-1], h2, e, CFG)
    with pytest.raises(ValueError):
        polyblock_solve_fused(beta[::2], h2[::2].contiguous(), e[::2].contiguous(), CFG)
    with pytest.raises(ValueError):
        polyblock_solve_fused(beta, h2.cpu(), e, CFG)


def test_empty_batches_launch_nothing(dev):
    z = torch.empty(0, dtype=torch.float64, device=dev)
    before = (polyblock_project.launches, polyblock_solve_fused.launches)
    assert polyblock_project(torch.empty(0, 2, dtype=torch.float64, device=dev),
                             z, z, z, CFG).shape == (0, 2)
    assert polyblock_solve_fused(z, z, z, CFG)[3].shape == (0,)
    assert (polyblock_project.launches, polyblock_solve_fused.launches) == before


@pytest.mark.parametrize("driver", [solve_pairs_fused, solve_pairs_step])
def test_drivers_on_the_card_match_the_cpu(dev, driver):
    rng = np.random.default_rng(5)
    h2 = rng.exponential(size=(3, 4, 30)) * 3
    beta = rng.integers(5, 60, 30).astype(np.float64)[None, None, :]
    got = driver(beta, h2, CFG, device=dev)
    want = driver(beta, h2, CFG, device="cpu")
    np.testing.assert_array_equal(got.feasible, want.feasible)
    same = got.iterations == want.iterations
    assert same.mean() > 0.97
    f = want.feasible & same
    for field in ("tau", "p", "time_s", "energy_j"):
        np.testing.assert_allclose(getattr(got, field)[f], getattr(want, field)[f],
                                   rtol=1e-9)


SMALL = dict(rounds=6, n_devices=8, n_subchannels=3, n_samples=96, batch=16,
             local_steps=2)


@pytest.mark.parametrize("engine,aggregation", [("loop", "sync"), ("scan", "sync"),
                                                ("async", "async"),
                                                ("async", "async_full")])
def test_simulation_traces_match_the_cpu(dev, engine, aggregation):
    """Every engine on the card against the same run on the CPU: the same
    draws (a CPU generator feeds both), so decisions are exact, the float32
    leader plane's latencies agree to 1e-6, and float32 training on the
    card drifts from the CPU's only by summation order (1e-4)."""
    cfg = SimConfig(**SMALL, aggregation=aggregation, scenario="churn")
    before = fedavg_aggregate.launches
    got = run_simulation(cfg, engine=engine, device=dev)
    assert fedavg_aggregate.launches > before           # K3 on every engine
    want = run_simulation(cfg, engine=engine, device="cpu")
    np.testing.assert_array_equal(got.tx_trace, want.tx_trace)
    np.testing.assert_array_equal(got.age_trace, want.age_trace)
    if want.commit_trace is not None:
        np.testing.assert_array_equal(got.commit_trace, want.commit_trace)
    np.testing.assert_allclose(got.latency_all, want.latency_all, rtol=1e-6)
    np.testing.assert_allclose(got.global_loss, want.global_loss, rtol=1e-4)


def test_full_buffer_is_bitwise_scan_on_the_card(dev):
    """K3 is deterministic (no atomics, slot order fixed), so the async
    engine's full-buffer limit reproduces the scan engine bit for bit on
    the card too."""
    scan = run_simulation(SimConfig(**SMALL, scenario="churn"), engine="scan", device=dev)
    asy = run_simulation(SimConfig(**SMALL, scenario="churn", aggregation="async_full"),
                         device=dev)
    for name in ("tx_trace", "age_trace", "latency_all", "energy_all", "global_loss",
                 "accuracy", "n_selected", "n_transmitted"):
        np.testing.assert_array_equal(getattr(asy, name), getattr(scan, name),
                                      err_msg=name)
    np.testing.assert_array_equal(asy.commit_trace, scan.tx_trace)


@pytest.mark.parametrize("k,n", [(4, 100352), (16, 1 << 20), (3, 7)])
def test_fedavg_kernel_matches_plain(dev, k, n):
    """The kernel and the plain version make the same float32 operations
    in the same order (slot-order sums, true division, no contraction), so
    they agree to the bit; all-zero weights give 0, one non-zero slot gives
    that slot."""
    gen = torch.Generator(dev).manual_seed(k)
    x = torch.randn(k, n, generator=gen, device=dev)
    for w in (torch.rand(k, generator=gen, device=dev) * 50,
              torch.zeros(k, device=dev),
              torch.nn.functional.one_hot(torch.tensor(k - 1), k).float().to(dev) * 7):
        before = fedavg_aggregate.launches
        got = fedavg_aggregate(x, w)
        torch.cuda.synchronize()
        assert fedavg_aggregate.launches == before + 1
        torch.testing.assert_close(got, fedavg_agg_plain(x, w), rtol=0, atol=0)
    assert torch.equal(fedavg_aggregate(x, torch.zeros(k, device=dev)),
                       torch.zeros(n, device=dev))
    torch.testing.assert_close(got, x[k - 1], rtol=0, atol=0)


def test_fedavg_tree_on_the_card(dev):
    leaves = {"a": torch.randn(4, 128, 784, device=dev), "b": torch.randn(4, 10, device=dev)}
    w = torch.tensor([1.0, 0.0, 3.0, 2.0], device=dev)
    got = fedavg_aggregate_tree(leaves, w)
    for name, v in leaves.items():
        torch.testing.assert_close(got[name], fedavg_agg_plain(v.reshape(4, -1), w)
                                   .reshape(v.shape[1:]), rtol=0, atol=0)


def test_fedavg_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x = torch.randn(4, 64, device=dev)
    w = torch.rand(4, device=dev)
    with pytest.raises(ValueError):
        fedavg_aggregate(x.double(), w.double())
    with pytest.raises(ValueError):
        fedavg_aggregate(x, w.double())
    with pytest.raises(ValueError):
        fedavg_aggregate(x[:, ::2], w)                            # not contiguous
    with pytest.raises(ValueError):
        fedavg_aggregate(x, w.cpu())
    with pytest.raises(ValueError):
        fedavg_aggregate(x, w[:3])
