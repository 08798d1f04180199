"""The port's CUDA kernels against their plain torch versions, on the card.

Needs an NVIDIA GPU with nvcc (the kernels build on first use); every test
here is marked `cuda` and skips where torch sees no CUDA device.  This file
imports no JAX, so it runs on a GPU machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import RoundPolicy
from repro_torch.experiments import SweepSpec, run_sweep
from repro_torch.service import ServiceConfig, SustainedService
from repro_torch.core import WirelessConfig, is_infeasible
from repro_torch.core.monotonic_torch import solve_pairs_fused, solve_pairs_step
from repro_torch.fl import (HierSimConfig, SimConfig, run_hier_many, run_hierarchical,
                            run_simulation)
from repro_torch.kernels import _build, flash_attention, flash_attention_plain, wkv6, wkv6_plain
from repro_torch.fl.server import aggregate, aggregate_buffered
from repro_torch.kernels.fedavg_agg import (fedavg_agg_plain, fedavg_aggregate,
                                            fedavg_aggregate_leaves, fedavg_aggregate_tree)
from repro_torch.kernels.polyblock_fused.ops import (LANES, coop_lanes, polyblock_solve_fused,
                                                     polyblock_solve_plain)
from repro_torch.kernels.polyblock_project.ops import (LANES as PROJECT_LANES,
                                                       polyblock_project, project_bisect,
                                                       project_lanes)
from repro_torch.launch.serve import serve_loop
from repro_torch.models.transformer import forward, init_params

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
@pytest.mark.parametrize("n", [1, 7, 33, 600])
def test_every_project_lanes_is_bitwise_the_one_lane_schedule(dev, dtype, n):
    """project_coop_kernel at 4, 8 and 16 lanes per vertex (and the
    wrapper's own choice) against project_kernel, one thread per vertex:
    the same bits, with ragged tail warps (1, 7, 33 vertices), on random
    (0.05, 1]^2 vertices (feasible and not) and on eq.-23 children of
    projected (1, 1) vertices (all outside G); one launch per call."""
    beta, h2, e = (x[:n].contiguous() for x in _pairs(n=2 * n + 16, seed=n, dev=dev,
                                                       dtype=dtype))
    assert beta.shape == (n,)
    gen = torch.Generator(dev).manual_seed(n)
    rand = torch.rand(n, 2, dtype=dtype, device=dev, generator=gen) * 0.95 + 0.05
    one = torch.ones(n, 2, dtype=dtype, device=dev)
    phi = project_bisect(one, beta, h2, e, CFG)
    child = torch.stack([phi[:, 0], one[:, 1]], -1)
    for v in (rand, child):
        want = polyblock_project(v, beta, h2, e, CFG, lanes=1)
        for lanes in [x for x in PROJECT_LANES if x > 1] + [None]:
            before = polyblock_project.launches
            got = polyblock_project(v, beta, h2, e, CFG, lanes=lanes)
            torch.cuda.synchronize()
            assert polyblock_project.launches == before + 1
            assert torch.equal(got, want), (lanes, dtype)
    assert project_lanes(n) in PROJECT_LANES


def test_project_lanes_feasible_vertices_and_refused_lanes(dev):
    """A batch already inside G comes back unchanged (zeta = 1) on every
    schedule, and a lanes value the C entry does not take raises a
    ValueError before any launch."""
    beta, h2, e = _pairs(n=300, dev=dev)
    v = torch.full((beta.shape[0], 2), 1e-3, dtype=torch.float64, device=dev)
    for lanes in PROJECT_LANES:
        got = polyblock_project(v, beta, h2, e, CFG, lanes=lanes)
        torch.cuda.synchronize()
        assert torch.equal(got, v), lanes
    before = polyblock_project.launches
    for lanes in (2, 32, 0):
        with pytest.raises(ValueError, match="lanes"):
            polyblock_project(v, beta, h2, e, CFG, lanes=lanes)
    assert polyblock_project.launches == before


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,max_iter", [(2000, 64), (37, 3), (1, 64)])
def test_every_lanes_choice_is_bitwise_the_one_lane_schedule(dev, dtype, n, max_iter):
    """The cooperative schedule at 4, 8 and 16 lanes per child (and the
    wrapper's own choice) against solve_kernel, one thread per pair: the
    same bits in all four outputs (ragged warps: 37 and 1 pairs; max_iter
    cutting pairs short), one launch per call."""
    args = [x[:n].contiguous() for x in _pairs(n=2 * n + 16, seed=n, dev=dev, dtype=dtype)]
    assert args[0].shape == (n,)
    want = polyblock_solve_fused(*args, CFG, max_iter=max_iter, lanes=1)
    for lanes in [x for x in LANES if x > 1] + [None]:
        before = polyblock_solve_fused.launches
        got = polyblock_solve_fused(*args, CFG, max_iter=max_iter, lanes=lanes)
        torch.cuda.synchronize()
        assert polyblock_solve_fused.launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w), (lanes, dtype)
    assert coop_lanes(n) in LANES


def test_too_large_a_store_for_shared_memory_raises(dev):
    """With lanes > 1 the vertex store lives in shared memory: a max_iter
    whose store does not fit a block's 227 KB raises a ValueError naming
    the limit (never a quiet fallback); the largest that fits runs, and
    lanes=1 (store in global memory) takes the larger one."""
    lib = _build.load_polyblock()
    args = _pairs(n=300, dev=dev)
    for lanes in (4, 8, 16):
        limit = lib.polyblock_solve_max_iter(lanes, 8)
        assert limit >= 64
        with pytest.raises(ValueError, match="227 KB"):
            polyblock_solve_fused(*args, CFG, max_iter=limit + 1, lanes=lanes)
        got = polyblock_solve_fused(*args, CFG, max_iter=limit, lanes=lanes)
        want = polyblock_solve_fused(*args, CFG, max_iter=limit, lanes=1)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    polyblock_solve_fused(*args, CFG, max_iter=lib.polyblock_solve_max_iter(4, 8) + 1, lanes=1)
    torch.cuda.synchronize()
    with pytest.raises(ValueError):
        polyblock_solve_fused(*args, CFG, lanes=2)


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
    before = fedavg_aggregate_leaves.launches
    got = run_simulation(cfg, engine=engine, device=dev)
    # K3 once per aggregation on every engine: every round with a
    # transmission (loop, scan), every commit event (async, one per round).
    aggregations = cfg.rounds if engine == "async" else int(got.tx_trace.any(1).sum())
    assert fedavg_aggregate_leaves.launches - before == aggregations > 0
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


HIER_SMALL = dict(rounds=6, n_cells=2, devices_per_cell=8, subchannels_per_cell=3,
                  n_samples=96, batch=16, local_steps=2, scenario="churn")


@pytest.mark.parametrize("engine", ["loop", "scan", "async"])
def test_hierarchy_traces_match_the_cpu(dev, engine):
    """The hierarchy on the card against the same run on the CPU: one K1
    launch for all cells' pairs; K3 once per aggregation — per cell that
    trained plus the global one (loop: rounds in which any cell trained;
    scan: every round), and on the async engine one per cell and one global
    per event."""
    cfg = HierSimConfig(**HIER_SMALL, aggregation="async" if engine == "async" else "sync",
                        global_aggregation="async" if engine == "async" else "sync")
    k1, k3 = polyblock_solve_fused.launches, fedavg_aggregate_leaves.launches
    got = run_hierarchical(cfg, engine=engine, device=dev)
    assert polyblock_solve_fused.launches - k1 == 1
    trained = got["tx"].any(axis=2)
    want_k3 = {"loop": trained.sum() + trained.any(axis=1).sum(),
               "scan": trained.sum() + cfg.rounds,
               "async": cfg.rounds * (cfg.n_cells + 1)}[engine]
    assert fedavg_aggregate_leaves.launches - k3 == want_k3
    want = run_hierarchical(cfg, engine=engine, device="cpu")
    for name in ("tx", "age", "committed", "cell_committed"):
        if name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_allclose(got["latency"], want["latency"], rtol=1e-6)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)


def test_hier_full_buffers_are_bitwise_scan_on_the_card(dev):
    scan = run_hier_many([HierSimConfig(**HIER_SMALL)], engine="scan", device=dev)[0]
    asy = run_hier_many([HierSimConfig(**HIER_SMALL, aggregation="async_full",
                                       global_aggregation="async_full")], device=dev)[0]
    for name in ("tx_trace", "age_trace", "latency_all", "energy_all", "global_loss",
                 "accuracy", "n_selected", "n_transmitted"):
        np.testing.assert_array_equal(getattr(asy, name), getattr(scan, name),
                                      err_msg=name)
    np.testing.assert_array_equal(asy.commit_trace, scan.tx_trace)


def test_sweep_on_the_card_matches_the_cpu(dev):
    """run_sweep over sync / async x 1 / 2 cells: Γ on K1 (one solve for
    the flat worlds, one per hierarchical world), every aggregation on K3,
    and each cell's traces equal to the same sweep on the CPU."""
    spec = SweepSpec(name="t", ds="alg3", aggregation=("sync", "async"), cell_counts=(1, 2),
                     rounds=6, n_devices=8, n_subchannels=4,
                     overrides={"n_samples": 96, "batch": 16, "local_steps": 2})
    k1, k3 = polyblock_solve_fused.launches, fedavg_aggregate_leaves.launches
    got = run_sweep(spec, device=dev, write=False)
    assert polyblock_solve_fused.launches - k1 == 2
    assert fedavg_aggregate_leaves.launches - k3 > 0
    assert got.record["env"]["torch_device"].startswith("cuda")
    want = run_sweep(spec, device="cpu", write=False)
    for g, w in zip(got.histories, want.histories):
        np.testing.assert_array_equal(g.tx_trace, w.tx_trace)
        np.testing.assert_array_equal(g.age_trace, w.age_trace)
        np.testing.assert_allclose(g.global_loss, w.global_loss, rtol=1e-4)


def test_service_on_the_card_chains_and_matches_the_cpu(dev):
    """SustainedService with ra="mo": K1 once per segment, K3 once per
    event, 3 chained segments of 4 events bitwise one of 12 on the card,
    and the card's segment equal to the CPU's in every trace."""
    sim = SimConfig(dataset="mnist", n_devices=8, n_subchannels=3, n_samples=96, batch=16,
                    local_steps=1, scenario="churn", aggregation="async",
                    policy=RoundPolicy(ra="mo"))

    def service(events, device):
        return SustainedService(ServiceConfig(sim=sim, segment_events=events,
                                              eval_every_events=2), device=device)

    k1, k3 = polyblock_solve_fused.launches, fedavg_aggregate_leaves.launches
    one = service(12, dev).run_segment()
    assert (polyblock_solve_fused.launches - k1, fedavg_aggregate_leaves.launches - k3) == (1, 12)
    chained = service(4, dev)
    parts = [chained.run_segment() for _ in range(3)]
    for name, v in one.items():
        np.testing.assert_array_equal(np.concatenate([p[name] for p in parts]), v,
                                      err_msg=name)
    cpu = service(12, "cpu").run_segment()
    for name in ("transmitted", "committed", "age", "n_pending"):
        np.testing.assert_array_equal(one[name], cpu[name], err_msg=name)
    np.testing.assert_allclose(one["loss"], cpu["loss"], rtol=1e-4)


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
        before = fedavg_aggregate_leaves.launches
        got = fedavg_aggregate(x, w)
        torch.cuda.synchronize()
        assert fedavg_aggregate_leaves.launches == before + 1
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


def _unaligned(k, n, dev, gen):
    """A contiguous (k, n) view that starts 4 bytes past a 16-byte boundary."""
    flat = torch.randn(k * n + 1, generator=gen, device=dev)
    x = flat[1:].view(k, n)
    assert x.is_contiguous() and x.data_ptr() % 16
    return x


@pytest.mark.parametrize("k", [4, 1, 16])
def test_grouped_fedavg_matches_plain_leaf_by_leaf(dev, k):
    """One launch over leaves of odd and aligned sizes, an empty leaf, a
    (K, 7, 5) and a (K,) leaf, and rows off the 16-byte boundary (scalar
    path beside float4): every output, in the leaf's trailing shape,
    bitwise the plain version's; all-zero weights give 0, one non-zero
    slot that slot."""
    gen = torch.Generator(dev).manual_seed(k)
    leaves = [torch.randn(k, n, generator=gen, device=dev) for n in (100352, 10, 0, 257, 4, 1)]
    leaves += [torch.randn(k, 7, 5, generator=gen, device=dev), torch.randn(k, device=dev)]
    leaves += [_unaligned(k, 1024, dev, gen), _unaligned(k, 33, dev, gen)]
    one = torch.zeros(k, device=dev)
    one[k - 1] = 7.0
    for w in (torch.rand(k, generator=gen, device=dev) * 50, torch.zeros(k, device=dev), one):
        before = fedavg_aggregate_leaves.launches
        got = fedavg_aggregate_leaves(leaves, w)
        torch.cuda.synchronize()
        assert fedavg_aggregate_leaves.launches == before + 1
        for g, x in zip(got, leaves):
            assert g.shape == x.shape[1:]
            torch.testing.assert_close(g, fedavg_agg_plain(x, w), rtol=0, atol=0)
    assert all(torch.equal(g, x[k - 1]) for g, x in zip(got, leaves))


def test_grouped_fedavg_past_one_table(dev):
    """More leaves than one table holds (64): one launch per table, the
    same bits."""
    gen = torch.Generator(dev).manual_seed(3)
    leaves = [torch.randn(4, 1 + 37 * j, generator=gen, device=dev) for j in range(150)]
    w = torch.rand(4, generator=gen, device=dev)
    before = fedavg_aggregate_leaves.launches
    got = fedavg_aggregate_leaves(leaves, w)
    torch.cuda.synchronize()
    assert fedavg_aggregate_leaves.launches == before + 3
    for g, x in zip(got, leaves):
        torch.testing.assert_close(g, fedavg_agg_plain(x, w), rtol=0, atol=0)
    assert fedavg_aggregate_leaves([torch.empty(4, 0, device=dev)], w)[0].shape == (0,)
    assert fedavg_aggregate_leaves.launches == before + 3      # nothing to launch


def test_server_aggregations_launch_k3_once(dev):
    """`aggregate` and `aggregate_buffered` over the mnist MLP's six leaves:
    one K3 launch each, the same bits as the CPU run of the same call."""
    gen = torch.Generator(dev).manual_seed(9)
    shapes = {"w1": (128, 784), "b1": (128,), "w2": (256, 128), "b2": (256,),
              "w3": (10, 256), "b3": (10,)}
    g = {k: torch.randn(s, generator=gen, device=dev) for k, s in shapes.items()}
    c = {k: torch.randn((4,) + s, generator=gen, device=dev) for k, s in shapes.items()}
    w = torch.tensor([2.0, 0.0, 5.0, 1.0], device=dev)
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}
    for call, extra in ((aggregate, ()), (aggregate_buffered, (torch.tensor(0.5, device=dev),))):
        before = fedavg_aggregate_leaves.launches
        got = call(g, c, w, *extra)
        torch.cuda.synchronize()
        assert fedavg_aggregate_leaves.launches == before + 1
        want = call(cpu(g), cpu(c), w.cpu(), *(x.cpu() for x in extra))
        for k in shapes:
            torch.testing.assert_close(got[k].cpu(), want[k], rtol=0, atol=0)


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


# --------------------------------------------------------------------------
# K4 flash attention and K5 WKV6 (the model zoo's serving path)
# --------------------------------------------------------------------------

def _rel_max(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _bf16_ulp(x):
    x = x.double().abs().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,window", [
    (4, 512, 512, 28, 4, 128, 0),        # qwen2-7b prefill at the serving shape
    (2, 100, 300, 8, 2, 128, 64),        # right-aligned queries, window, ragged tiles
    (2, 64, 64, 4, 2, 64, 0),            # the smoke configs' head dim
    (1, 33, 70, 7, 1, 64, 17),
    (8, 200, 333, 28, 4, 128, 0),        # more query blocks than SMs; Sq, Sk off the tiles
    (1, 130, 260, 4, 4, 64, 100)])       # G = 1, a window across a tile edge
def test_flash_kernel_matches_plain(dev, dtype, b, sq, sk, hq, hkv, d, window):
    """Both accumulate in f32 and cast once: f32 within 1e-5 (summation
    order, FMA), bf16 within one ulp plus that floor."""
    gen = torch.Generator(dev).manual_seed(sq + window)
    q = torch.randn(b, sq, hq, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=gen, device=dev).to(dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=True, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    diff = (got.double() - want.double()).abs()
    if dtype == torch.float32:
        assert diff.max().item() < 1e-5
    else:
        assert bool((diff <= _bf16_ulp(torch.maximum(got.abs(), want.abs())) + 1e-5).all())


@pytest.mark.parametrize("b,t,h,hs", [(4, 512, 64, 64), (4, 1, 64, 64), (3, 37, 5, 32),
                                      (2, 70, 3, 64)])      # ragged: the last 16-step chunk holds 6
def test_wkv6_kernel_matches_plain(dev, b, t, h, hs):
    """The rwkv6-7b prefill and T = 1 decode shapes (and a smoke-size one),
    random non-zero u and initial state: kernel and plain version make the
    same f32 operations in the same order (one pairwise tree over i, no
    contraction), so y and the final state agree to the bit."""
    gen = torch.Generator(dev).manual_seed(t)
    r, k, v = (torch.randn(b, t, h, hs, generator=gen, device=dev) for _ in range(3))
    w = torch.exp(-torch.exp(torch.rand(b, t, h, hs, generator=gen, device=dev) * 7 - 7))
    u = torch.randn(h, hs, generator=gen, device=dev)
    s0 = torch.randn(b, h, hs, hs, generator=gen, device=dev)
    before = wkv6.launches
    y, s = wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    y_p, s_p = wkv6_plain(r, k, v, w, u, s0)
    assert torch.equal(y, y_p) and torch.equal(s, s_p)


def test_flash_bf16_kernel_runs_on_the_tensor_cores(dev):
    """The bf16 K4 entry's kernel (both head dims) issues wgmma: HGMMA in
    its SASS; the f32 SIMT kernel issues none."""
    counts = _build.sass_opcodes("flash_attention", ("HGMMA", "HMMA"))
    tc = {name: c for name, c in counts.items() if "flash_fwd_bf16_wgmma" in name}
    assert len(tc) == 2, sorted(counts)
    assert all(c["HGMMA"] > 0 for c in tc.values()), tc
    simt = {name: c for name, c in counts.items() if "flash_fwd_kernel" in name}
    assert simt and all(c["HGMMA"] == 0 and c["HMMA"] == 0 for c in simt.values()), simt


def test_flash_bf16_rejects_a_view_off_the_16_byte_boundary(dev):
    """The bf16 kernel reads q, k and v by TMA, which needs them 16-byte
    aligned: a contiguous view at an odd offset raises a ValueError that
    says so, and the same view in f32 (SIMT kernel) still runs."""
    shape = (1, 16, 4, 64)
    for dtype in (torch.bfloat16, torch.float32):
        flat = torch.randn(1 + 16 * 4 * 64, device=dev).to(dtype)
        odd = flat[1:].view(shape)
        kv = torch.randn(1, 16, 2, 64, device=dev).to(dtype)
        assert odd.is_contiguous() and odd.data_ptr() % 16
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match="16-byte"):
                flash_attention(odd, kv, kv, causal=True)
        else:
            got = flash_attention(odd, kv, kv, causal=True)
            want = flash_attention_plain(odd, kv, kv, causal=True)
            assert (got - want).abs().max().item() < 1e-5


def test_llm_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.randn(1, 16, 4, 64, device=dev, dtype=torch.bfloat16)
    kv = torch.randn(1, 16, 2, 64, device=dev, dtype=torch.bfloat16)
    for bad in (dict(q=q.half(), k=kv.half(), v=kv.half()),            # dtype
                dict(q=q, k=kv.float(), v=kv),                          # mixed dtypes
                dict(q=q.transpose(1, 2).contiguous().transpose(1, 2), k=kv, v=kv),  # layout
                dict(q=q[..., :48].contiguous(), k=kv[..., :48].contiguous(),
                     v=kv[..., :48].contiguous()),                      # head dim 48
                dict(q=q[:, :, :3].contiguous(), k=kv, v=kv),           # Hq % Hkv
                dict(q=torch.cat([q, q], 1), k=kv, v=kv),               # Sq > Sk
                dict(q=q, k=kv.cpu(), v=kv)):                           # device
        with pytest.raises(ValueError):
            flash_attention(bad["q"], bad["k"], bad["v"], causal=True)
    r = torch.randn(2, 3, 4, 32, device=dev)
    u, s0 = torch.randn(4, 32, device=dev), torch.randn(2, 4, 32, 32, device=dev)
    for bad in ((r.bfloat16(),) * 4 + (u, s0),                          # dtype
                (r.transpose(1, 2).contiguous().transpose(1, 2), r, r, r, u, s0),  # layout
                (r, r, r, r, u[:3], s0),                                # u shape
                (r[..., :16].contiguous(),) * 4 + (u[:, :16].contiguous(),
                                                   s0[..., :16, :16].contiguous()),  # hs 16
                (r, r, r, r.cpu(), u, s0)):                             # device
        with pytest.raises(ValueError):
            wkv6(*bad)


@pytest.mark.parametrize("arch", ["qwen2-7b-smoke", "rwkv6-7b-smoke"])
def test_serve_loop_on_the_card_goes_through_the_kernels(dev, arch):
    """serve_loop with the kernel path on the card: K4 once per attention
    layer (prefill), K5 once per RWKV layer in prefill and in each of the
    new_tokens + 1 decode steps (warm-up included); prefill logits within
    4e-2 of the same weights on the CPU's plain versions."""
    cfg = dataclasses.replace(get_config(arch), attn_impl="pallas", rwkv_wkv_impl="pallas")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    on_card = _to(params, dev)
    flash_attention.launches = wkv6.launches = 0
    res = serve_loop(cfg, batch=2, prompt_len=64, new_tokens=4, device=dev, params=on_card)
    attn = cfg.family == "dense"
    assert flash_attention.launches == (cfg.n_layers if attn else 0)
    assert wkv6.launches == (0 if attn else cfg.n_layers * (1 + 4 + 1))
    assert res.tokens.shape == (2, 5) and ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()
    toks = torch.randint(0, cfg.vocab, (2, 64), generator=torch.Generator().manual_seed(1))
    got = forward(cfg, on_card, {"tokens": toks.to(dev)})[0]
    want = forward(cfg, params, {"tokens": toks})[0]
    assert bool(torch.isfinite(got.float()).all())
    assert _rel_max(got.float().cpu(), want.float()) < 4e-2


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)
