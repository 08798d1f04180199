"""The port's Algorithm-1 kernels, plain versions against the JAX package.

K2 (projection): `project_bisect` against `project_jnp` (float64) and the
Pallas kernel in interpret mode (float32).  K1 (whole solve):
`polyblock_solve_plain` against `polyblock_solve_fused(interpret=True)` in
float64 and float32.  The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py); here each wrapper is given CPU tensors, where
it runs its plain version.
"""
from _torch_oracle import enable_x64, feasible_pairs, rel_err  # noqa: I001  (alias first)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.polyblock_fused.ops import polyblock_solve_fused as jax_fused
from repro.kernels.polyblock_project.ops import project_jnp, project_pallas
from repro_torch.core.wireless import WirelessConfig as PortConfig
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
