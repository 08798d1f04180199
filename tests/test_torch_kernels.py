"""The port's kernels, plain versions against the JAX package.

K2 (projection): `project_bisect` against `project_jnp` (float64) and the
Pallas kernel in interpret mode (float32).  K1 (whole solve):
`polyblock_solve_plain` against `polyblock_solve_fused(interpret=True)` in
float64 and float32.  K3 (eq.-34 mean): `fedavg_agg_plain` against the
Pallas kernel in interpret mode and its jnp oracle.  The CUDA kernels
themselves run only on the card
(tests/test_torch_cuda.py); here each wrapper is given CPU tensors, where
it runs its plain version.
"""
from _torch_oracle import enable_x64, feasible_pairs, rel_err  # noqa: I001  (alias first)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fedavg_agg.ops import fedavg_aggregate as jax_fedavg
from repro.kernels.fedavg_agg.ops import fedavg_aggregate_tree as jax_fedavg_tree
from repro.kernels.fedavg_agg.ref import fedavg_agg_ref
from repro.kernels.polyblock_fused.ops import polyblock_solve_fused as jax_fused
from repro.kernels.polyblock_project.ops import project_jnp, project_pallas
from repro_torch.core.wireless import WirelessConfig as PortConfig
from repro_torch.fl.server import masked_weighted_mean
from repro_torch.kernels.fedavg_agg import (fedavg_agg_plain, fedavg_aggregate,
                                            fedavg_aggregate_tree)
from repro_torch.kernels.polyblock_fused.ops import (polyblock_solve_fused,
                                                     polyblock_solve_plain)
from repro_torch.kernels.polyblock_project.ops import (polyblock_project,
                                                       project_bisect)

PCFG = PortConfig()


def _vertices(n=600, seed=11):
    """Vertices in (0.05, 1]^2 over feasible pairs (the JAX package's
    projection-agreement draw); infeasible pairs would bisect to TINY."""
    beta, h2, cfg = feasible_pairs(n, seed)
    rng = np.random.default_rng(seed + 1)
    v = np.stack([rng.uniform(0.05, 1, beta.size),
                  rng.uniform(0.05, 1, beta.size)], -1)
    return v, beta, h2, np.full(beta.size, cfg.e_max_j), cfg


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def test_project_bisect_f64_matches_project_jnp():
    """Same arithmetic in the same order: the only difference left is the
    last ulp of log1p (torch and XLA evaluate it differently), which can
    flip a bisection step only once the bracket is a few ulps wide — so
    1e-13 relative."""
    v, beta, h2, e_max, cfg = _vertices()
    with enable_x64():
        want = np.asarray(project_jnp(*(jnp.asarray(x) for x in (v, beta, h2, e_max)), cfg))
    got = project_bisect(*(_t(x) for x in (v, beta, h2, e_max)), PCFG).numpy()
    assert rel_err(got, want) < 1e-13


def test_project_bisect_f32_matches_pallas_interpret():
    """float32 against the Pallas kernel in float32 interpret mode.  In
    float32 the root is resolved only to where g's rounding noise meets its
    slope, so a last-ulp log1p difference can move zeta by more than an
    ulp: 1e-4 relative, the JAX package's own float32 projection contract
    (tests/test_monotonic_jax.py::test_projection_backends_agree)."""
    v, beta, h2, e_max, cfg = _vertices()
    want = np.asarray(project_pallas(v, beta, h2, e_max, cfg, interpret=True))
    got = project_bisect(*(_t(x, torch.float32) for x in (v, beta, h2, e_max)),
                         PCFG).numpy()
    assert got.dtype == np.float32
    assert rel_err(got, want) < 1e-4


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_project_wrapper_on_cpu_is_the_plain_version(dtype):
    v, beta, h2, e_max, _ = _vertices(n=200)
    args = [_t(x, dtype) for x in (v, beta, h2, e_max)]
    before = polyblock_project.launches
    torch.testing.assert_close(polyblock_project(*args, PCFG),
                               project_bisect(*args, PCFG), rtol=0, atol=0)
    assert polyblock_project.launches == before      # no kernel on the CPU


def test_project_feasible_vertex_keeps_zeta_one():
    """Where g(v) <= 0 the vertex is its own projection (theta = 1)."""
    v = torch.tensor([[1e-3, 1e-3]], dtype=torch.float64)
    one = torch.ones(1, dtype=torch.float64)
    out = project_bisect(v, one * 10, one * 100.0, one * 1.0, PCFG)
    assert torch.equal(out, v)


def test_plain_fused_f64_matches_pallas_interpret():
    """float64: the Pallas kernel in interpret mode is bit-identical to the
    JAX bisect driver; the plain torch version follows the same trajectory
    on every pair (iterations exact) and lands within 1e-12 relative (the
    log1p ulp, carried through the bisection and the eq.-8 objective)."""
    beta, h2, cfg = feasible_pairs(400, seed=21)
    with enable_x64():
        ref = [np.asarray(x) for x in jax_fused(beta, h2, cfg.e_max_j, cfg,
                                                interpret=True, dtype=np.float64)]
    e = np.full(beta.size, cfg.e_max_j)
    got = [x.numpy() for x in polyblock_solve_plain(_t(beta), _t(h2), _t(e), PCFG)]
    np.testing.assert_array_equal(got[3], ref[3])
    for g, w in zip(got[:3], ref[:3]):
        assert rel_err(g, w) < 1e-12


def test_plain_fused_f32_matches_pallas_interpret():
    """float32, the contract of tests/test_kernels.py's fp32 study: more than
    97% of pairs on the oracle's trajectory and within 1e-4 relative there;
    a pair whose eq.-26 test sits within float32 noise of eps may retire one
    iteration early or late, and then stays within the tolerance itself,
    |dT| <= eps.  The oracle here is the Pallas kernel in float32 interpret
    mode, so both sides run the same float32 algorithm."""
    beta, h2, cfg = feasible_pairs(400, seed=22)
    ref = [np.asarray(x) for x in jax_fused(beta, h2, cfg.e_max_j, cfg,
                                            interpret=True, dtype=np.float32)]
    e = np.full(beta.size, cfg.e_max_j)
    got = [x.numpy() for x in polyblock_solve_plain(
        *(_t(x, torch.float32) for x in (beta, h2, e)), PCFG)]
    same = got[3] == ref[3]
    assert same.mean() > 0.97, f"trajectory drift on {(~same).mean():.1%}"
    assert np.abs(got[3].astype(np.int64) - ref[3]).max() <= 1
    for g, w in zip(got[:3], ref[:3]):
        assert rel_err(g[same], w[same]) < 1e-4
    assert np.all(np.abs(got[2][~same].astype(np.float64) - ref[2][~same]) <= 0.01 + 1e-6)


def test_fused_wrapper_on_cpu_is_the_plain_version():
    beta, h2, cfg = feasible_pairs(120, seed=23)
    e = np.full(beta.size, cfg.e_max_j)
    args = [_t(x) for x in (beta, h2, e)]
    before = polyblock_solve_fused.launches
    for g, w in zip(polyblock_solve_fused(*args, PCFG),
                    polyblock_solve_plain(*args, PCFG)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert polyblock_solve_fused.launches == before


def test_plain_fused_respects_max_iter():
    """max_iter caps every pair's iteration count, as in the Pallas loop."""
    beta, h2, cfg = feasible_pairs(200, seed=24)
    e = np.full(beta.size, cfg.e_max_j)
    with enable_x64():
        ref = np.asarray(jax_fused(beta, h2, cfg.e_max_j, cfg, max_iter=2,
                                   interpret=True, dtype=np.float64)[3])
    _, _, _, it = polyblock_solve_plain(_t(beta), _t(h2), _t(e), PCFG, max_iter=2)
    assert it.max().item() <= 2
    np.testing.assert_array_equal(it.numpy(), ref)


# ---------------------------------------------------------------------------
# K3: the eq.-34 weighted mean
# ---------------------------------------------------------------------------

K3_WEIGHTS = {
    "mixed": [3.0, 0.0, 5.0, 17.0],
    "all_zero": [0.0, 0.0, 0.0, 0.0],
    "one_slot": [0.0, 0.0, 42.0, 0.0],
}


def _k3_inputs(weights, n=5000, seed=31):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(len(weights), n)).astype(np.float32)
    return x, np.asarray(weights, np.float32)


@pytest.mark.parametrize("case", sorted(K3_WEIGHTS))
def test_fedavg_plain_matches_pallas_interpret(case):
    """float32 throughout: the Pallas kernel's (w / wsum) @ x and the jnp
    oracle's einsum sum the K products in their own order, the plain
    version in slot order, so they agree to 1e-6 relative (a few ulps);
    all-zero weights give exactly 0, one non-zero slot exactly that slot."""
    x, w = _k3_inputs(K3_WEIGHTS[case])
    got = fedavg_agg_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert got.dtype == np.float32 and got.shape == (x.shape[1],)
    for want in (np.asarray(jax_fedavg(jnp.asarray(x), jnp.asarray(w), interpret=True)),
                 np.asarray(fedavg_agg_ref(jnp.asarray(x), jnp.asarray(w)))):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if case == "all_zero":
        assert not got.any()
    if case == "one_slot":
        np.testing.assert_array_equal(got, x[2])


def test_fedavg_tree_matches_jax_tree():
    rng = np.random.default_rng(32)
    w = np.asarray([2.0, 0.0, 7.0], np.float32)
    leaves = {"a": rng.normal(size=(3, 7, 5)), "b": rng.normal(size=(3, 11)),
              "c": rng.normal(size=(3,))}
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    want = jax_fedavg_tree({k: jnp.asarray(v) for k, v in leaves.items()},
                           jnp.asarray(w), interpret=True)
    got = fedavg_aggregate_tree({k: torch.from_numpy(v) for k, v in leaves.items()},
                                torch.from_numpy(w))
    for k, v in leaves.items():
        assert got[k].shape == v.shape[1:]
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


def test_fedavg_wrappers_on_cpu_are_the_plain_version():
    """`fedavg_aggregate` and the server's `masked_weighted_mean` take the
    plain version for a CPU tensor, bit for bit, and launch nothing."""
    x, w = _k3_inputs(K3_WEIGHTS["mixed"], n=60)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    before = fedavg_aggregate.launches
    want = fedavg_agg_plain(xt, wt)
    torch.testing.assert_close(fedavg_aggregate(xt, wt), want, rtol=0, atol=0)
    torch.testing.assert_close(masked_weighted_mean(xt.reshape(4, 3, 20), wt),
                               want.reshape(3, 20), rtol=0, atol=0)
    assert fedavg_aggregate.launches == before
