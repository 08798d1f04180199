"""The simulation across devices, on the CPU: `shard=` of the port.

The port's `shard=` is single-controller like the JAX package's: one
process drives every local device, each shard on its own device
(`repro_torch.launch.mesh.local_devices`, `map_shards`).  Here the devices
are emulated, `emulate_devices(n)` making n copies of the CPU, as the JAX
package's tests force n host devices.  The contract is the JAX package's:

  * `solve_pairs_fused(shard=True)` pads the feasible rows to a multiple of
    the shard count, solves one block per device (one K1 launch per block;
    the plain backends' step loop likewise) and joins them in row order,
    every field bitwise `shard=False`, on every backend, on 77 x (3, 4)
    rows (pad-and-drop) and 96 x 4;
  * the port's sharded "mixed" against the JAX package's sharded "mixed"
    on 2 forced host devices (in a subprocess: the device count must be
    set before JAX starts): iterations exact, values within the
    tolerances of tests/test_torch_ra_backends.py;
  * `run_many` (scan, async), `run_hier_many` (scan, two-tier async) and
    `run_sweep` with `shard=True` over 2 and 3 shards, group sizes that
    do not divide the shard count, bitwise their `shard=False` runs in
    every field but the wall times.
"""
from _torch_oracle import HIER_SMALL, SMALL  # noqa: I001  (alias first)

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import RoundPolicy, WirelessConfig
from repro_torch.core import monotonic_torch
from repro_torch.core.monotonic_torch import solve_pairs_fused
from repro_torch.experiments import SweepSpec, run_sweep
from repro_torch.fl import HierSimConfig, SimConfig, run_hier_many, run_many
from repro_torch.launch import mesh
from repro_torch.launch.mesh import emulate_devices, local_devices, split_padded, use_shards

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("feasible", "iterations", "tau", "p", "time_s", "energy_j")
# The tolerances of tests/test_torch_ra_backends.py for "mixed" against
# the JAX package's "mixed".
MIXED_TOL = dict(tau=2e-11, p=2e-11, time_s=5e-12, energy_j=5e-12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors (as the other
    simulation test files): beside other test workers, torch's default
    oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(case):
    """The JAX package's sharding tests' draws: 77 devices x (3, 4)
    (K * N odd against 2 shards: pad-and-drop) or 96 x 4."""
    seed, n, shape = {"77x3x4": (17, 77, (3, 4)), "96x4": (13, 96, (4,))}[case]
    rng = np.random.default_rng(seed)
    beta = rng.integers(5, 60, n).astype(float)
    h2 = rng.exponential(size=shape + (n,)) * 3
    return np.broadcast_to(beta, h2.shape), h2


# --------------------------------------------------------------------------
# the mesh module's shard helpers
# --------------------------------------------------------------------------

def test_local_devices_and_the_shard_rule():
    assert local_devices("cpu") == [torch.device("cpu")]
    with emulate_devices(3):
        assert local_devices("cpu") == [torch.device("cpu")] * 3
        with emulate_devices(2):
            assert len(local_devices("cpu")) == 2
        assert len(local_devices("cpu")) == 3
    assert local_devices("cpu") == [torch.device("cpu")]
    one, two = [torch.device("cpu")], [torch.device("cpu")] * 2
    assert not use_shards(True, one) and not use_shards(None, one)
    assert use_shards(None, two) and use_shards(True, two) and not use_shards(False, two)
    assert split_padded(5, 2) == [[0, 1, 2], [3, 4, 0]]
    assert split_padded(2, 3) == [[0], [1], [0]]
    assert split_padded(6, 3) == [[0, 1], [2, 3], [4, 5]]
    with pytest.raises(ValueError):
        with emulate_devices(0):
            pass


def test_map_shards_raises_a_shards_failure():
    def fn(item, device):
        if item == 1:
            raise RuntimeError("shard 1 failed")
        return item

    assert mesh.map_shards(fn, [0, 2], [torch.device("cpu")] * 2) == [0, 2]
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        mesh.map_shards(fn, [0, 1, 2], [torch.device("cpu")] * 3)


# --------------------------------------------------------------------------
# the Γ solve
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 3])
@pytest.mark.parametrize("case", ["77x3x4", "96x4"])
@pytest.mark.parametrize("backend", [None, "bisect", "newton", "mixed"])
def test_gamma_sharded_is_bitwise_unsharded(backend, case, n_shards, monkeypatch):
    """Every field of the row-sharded solve bitwise the unsharded one; the
    rows solved in n_shards blocks of equal size (one K1 call per block on
    the kernel backend)."""
    beta, h2 = _rows(case)
    cfg = WirelessConfig()
    want = solve_pairs_fused(beta, h2, cfg, backend=backend, device="cpu", shard=False)
    name = "_fused_rows" if backend is None else "_step_rows"
    inner, sizes = getattr(monotonic_torch, name), []

    def counted(beta_w, *a, **kw):
        sizes.append(len(beta_w))
        return inner(beta_w, *a, **kw)

    monkeypatch.setattr(monotonic_torch, name, counted)
    with emulate_devices(n_shards):
        got = solve_pairs_fused(beta, h2, cfg, backend=backend, device="cpu", shard=True)
    n_work = int(want.feasible.sum())
    assert len(sizes) == n_shards and set(sizes) == {-(-n_work // n_shards)}
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field),
                                      err_msg=field)


@pytest.mark.parametrize("shard,n_devices,blocks", [
    (None, 1, 1), (True, 1, 1), (False, 2, 1), (None, 2, 2), (True, 2, 2)])
def test_gamma_shard_argument_follows_the_jax_rule(shard, n_devices, blocks, monkeypatch):
    """None shards when more than one device is visible, True on one device
    is the unsharded path, False never shards."""
    beta, h2 = _rows("96x4")
    calls = []
    inner = monotonic_torch._fused_rows
    monkeypatch.setattr(monotonic_torch, "_fused_rows",
                        lambda *a, **kw: calls.append(1) or inner(*a, **kw))
    with emulate_devices(n_devices):
        solve_pairs_fused(beta, h2, WirelessConfig(), device="cpu", shard=shard)
    assert len(calls) == blocks


_JAX_SHARDED_MIXED = textwrap.dedent("""
    import sys
    sys.path.insert(0, {tests!r})
    import _torch_oracle  # noqa: F401  (the enable_x64 alias, before repro)
    import jax
    import numpy as np
    from repro.core import WirelessConfig, solve_pairs_fused
    assert jax.local_device_count() == 2, jax.local_devices()
    rng = np.random.default_rng(17)
    n = 77
    beta = rng.integers(5, 60, n).astype(float)
    h2 = rng.exponential(size=(3, 4, n)) * 3
    ra = solve_pairs_fused(beta[None, None, :], h2, WirelessConfig(), backend="mixed",
                           shard=True)
    np.savez({out!r}, **{{f: np.asarray(getattr(ra, f)) for f in {fields!r}}})
""")


def test_gamma_sharded_mixed_matches_the_jax_sharded_mixed(tmp_path):
    """The port's "mixed" over 2 emulated shards against the JAX package's
    "mixed" over 2 forced host devices: iterations exact, values within
    the tolerances of the unsharded comparison."""
    out = tmp_path / "jax_sharded.npz"
    code = _JAX_SHARDED_MIXED.format(tests=os.path.join(REPO, "tests"), out=str(out),
                                     fields=FIELDS)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=2"),
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(out)
    beta, h2 = _rows("77x3x4")
    with emulate_devices(2):
        got = solve_pairs_fused(beta, h2, WirelessConfig(), backend="mixed", device="cpu",
                                shard=True)
    np.testing.assert_array_equal(got.feasible, want["feasible"])
    np.testing.assert_array_equal(got.iterations, want["iterations"])
    f = want["feasible"]
    assert f.any() and (~f).any()
    for field, tol in MIXED_TOL.items():
        g, w = getattr(got, field)[f], want[field][f]
        assert np.max(np.abs(g - w) / np.abs(w)) < tol, field


# --------------------------------------------------------------------------
# the groups
# --------------------------------------------------------------------------

def _assert_bitwise(a, b, what=""):
    """Every field of two histories but the wall times equal to the bit."""
    for f in dataclasses.fields(a):
        if f.name in ("wall_s", "plan_wall_s"):
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, dict):
            assert x.keys() == y.keys(), f.name
            for key in x:
                np.testing.assert_array_equal(x[key], y[key], err_msg=f"{what} {f.name}.{key}")
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {f.name}")
        else:
            assert x == y, f"{what} {f.name}"


def _flat_group(engine):
    """Five cells of one group (seeds x policies, a churn scenario; on the
    async engine three commit disciplines): 5 divides neither 2 nor 3."""
    pols = [RoundPolicy(ds="alg3"), RoundPolicy(ds="random"), RoundPolicy(ds="aou_topk")]
    aggs = ["async", "async_const", "async_full"] if engine == "async" else ["sync"] * 3
    return [SimConfig(**SMALL, seed=s, policy=pols[i % 3], aggregation=aggs[i % 3],
                      scenario="churn" if i == 4 else "static")
            for i, s in enumerate((0, 1, 2, 0, 1))]


@pytest.mark.parametrize("n_shards", [2, 3])
@pytest.mark.parametrize("engine", ["scan", "async"])
def test_run_many_sharded_is_bitwise_unsharded(engine, n_shards):
    cfgs = _flat_group(engine)
    want = run_many(cfgs, engine=engine, device="cpu", shard=False)
    with emulate_devices(n_shards):
        got = run_many(cfgs, engine=engine, device="cpu", shard=True)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_bitwise(g, w, f"cell {i}")


def test_run_many_sharded_wall_s_splits_the_dispatch_time():
    """A sharded member's wall_s is the whole dispatch's time over the
    group's size plus its own plan_wall_s, as unsharded."""
    cfgs = _flat_group("scan")[:3]
    with emulate_devices(2):
        got = run_many(cfgs, engine="scan", device="cpu", shard=True)
    shares = {round(h.wall_s - h.plan_wall_s, 9) for h in got}
    assert len(shares) == 1 and shares.pop() > 0


def test_run_many_loop_engine_shards_only_the_gamma_solve(monkeypatch):
    cfgs = [SimConfig(**SMALL, seed=s) for s in (0, 1, 2)]
    want = run_many(cfgs, engine="loop", device="cpu", shard=False)
    calls = []
    inner = monotonic_torch._fused_rows
    monkeypatch.setattr(monotonic_torch, "_fused_rows",
                        lambda *a, **kw: calls.append(1) or inner(*a, **kw))
    with emulate_devices(2):
        got = run_many(cfgs, engine="loop", device="cpu")       # shard=None: 2 devices
    assert len(calls) == 2
    for g, w in zip(got, want):
        _assert_bitwise(g, w)


def _hier_group(engine):
    """Three configs of one hierarchy group (policies, seeds, a coupled
    corr_fading world; on the async engine async commits at both tiers)."""
    agg = dict(aggregation="async", global_aggregation="async") if engine == "async" else {}
    return [HierSimConfig(**HIER_SMALL, seed=0, policy=RoundPolicy(ds="alg3"), **agg),
            HierSimConfig(**HIER_SMALL, seed=1, policy=RoundPolicy(ds="random"), **agg),
            HierSimConfig(**HIER_SMALL, seed=2, policy=RoundPolicy(ds="alg3"),
                          scenario="corr_fading", cell_coupling=0.5, **agg)]


@pytest.mark.parametrize("n_shards", [2, 3])
@pytest.mark.parametrize("engine", ["scan", "async"])
def test_run_hier_many_sharded_is_bitwise_unsharded(engine, n_shards):
    cfgs = _hier_group(engine)[: 3 if n_shards == 2 else 2]
    want = run_hier_many(cfgs, engine=engine, device="cpu", shard=False)
    with emulate_devices(n_shards):
        got = run_hier_many(cfgs, engine=engine, device="cpu", shard=True)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_bitwise(g, w, f"config {i}")


SWEEP = dict(name="t", datasets="mnist", ds=("alg3", "random"), aggregation=("sync", "async"),
             cell_counts=(1, 2), seeds=(0,), rounds=4, n_devices=8, n_subchannels=4,
             overrides={"n_samples": 96, "batch": 16, "local_steps": 2, "eval_every": 2})


def test_run_sweep_sharded_is_bitwise_unsharded():
    """Flat and hierarchical cells, sync and async, over 2 shards: every
    cell's curves and traces bitwise the unsharded sweep's."""
    want = run_sweep(SweepSpec(**SWEEP), engine="scan", device="cpu", write=False,
                     shard=False)
    with emulate_devices(2):
        got = run_sweep(SweepSpec(**SWEEP), engine="scan", device="cpu", write=False,
                        shard=True)
    assert len(got.histories) == len(want.histories) == 8
    for i, (g, w) in enumerate(zip(got.histories, want.histories)):
        _assert_bitwise(g, w, f"cell {i}")
    assert json.dumps(_no_walls(got.record["cells"]), sort_keys=True) \
        == json.dumps(_no_walls(want.record["cells"]), sort_keys=True)


def _no_walls(obj):
    """A record without its wall-time keys, at any depth."""
    if isinstance(obj, dict):
        return {k: _no_walls(v) for k, v in obj.items() if "wall" not in k}
    if isinstance(obj, list):
        return [_no_walls(v) for v in obj]
    return obj
