"""The cooperative schedules of K1 and K2, emulated in plain torch on the CPU.

The cooperative kernels (`solve_coop_kernel`, `project_coop_kernel`,
csrc/polyblock.cu) run only on the card; tests/test_torch_cuda.py holds
them bitwise equal to the one-thread schedules there.  Here their pieces
are emulated step for step and held to the sequential versions they
replace:

  * the speculative bisection (`project_speculative`, K1's children and
    K2's vertices): 2^d - 1 midpoints of the next d levels at once, then a
    walk of the signs, bit for bit `project_bisect` for every depth,
    n_bisect a multiple of d or not, vertices already feasible (zeta = 1),
    and K2's arbitrary (0.05, 1]^2 vertices, feasible and not;
  * the warp's selection (`first_max_lanes`): a strided scan and a
    butterfly over the pair's lanes, the serial scan's first max on ties
    and on -inf slots.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import WirelessConfig, is_infeasible
from repro_torch.kernels.polyblock_fused.ops import (LANES, coop_lanes, first_max_lanes,
                                                     polyblock_solve_fused,
                                                     polyblock_solve_plain)
from repro_torch.kernels.polyblock_project.ops import (LANES as PROJECT_LANES,
                                                       polyblock_project, project_bisect,
                                                       project_lanes, project_speculative)

CFG = WirelessConfig()


def _vertices(dtype, n=300, seed=41, pinned=True):
    """Vertices over feasible pairs: uniform in (0.05, 1]^2, and with
    `pinned` a fifth of them at (1e-3, 1e-3), inside G (zeta = 1).  Without
    it the draw alone mixes the two: about a third of the uniform vertices
    lie outside G, the rest inside (zeta = 1)."""
    rng = np.random.default_rng(seed)
    h2 = rng.exponential(size=n) * 3
    beta = rng.integers(5, 60, n).astype(np.float64)
    keep = ~is_infeasible(h2, CFG, np.full(n, CFG.e_max_j))
    h2, beta = h2[keep], beta[keep]
    v = rng.uniform(0.05, 1, (beta.size, 2))
    if pinned:
        v[: beta.size // 5] = 1e-3
    t = lambda x: torch.as_tensor(x, dtype=dtype)
    return t(v), t(beta), t(h2), t(np.full(beta.size, CFG.e_max_j))


# (depth, n_bisect, pinned): the last three are K2's depths (L = 4, 8, 16
# lanes per vertex) on its arbitrary vertices.
_SPECULATION = ([pytest.param(d, b, True, id=f"{d}-{b}")
                 for d, b in ((1, 60), (2, 60), (3, 60), (4, 60), (5, 60), (2, 61), (3, 61),
                              (4, 61), (5, 61), (4, 13), (7, 60))]
                + [pytest.param(d, 60, False, id=f"{d}-60-uniform") for d in (2, 3, 4)])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("depth,n_bisect,pinned", _SPECULATION)
def test_speculative_bisection_is_project_bisect(dtype, depth, n_bisect, pinned):
    args = _vertices(dtype, pinned=pinned)
    want = project_bisect(*args, CFG, n_bisect=n_bisect)
    got = project_speculative(*args, CFG, n_bisect=n_bisect, depth=depth)
    assert torch.equal(got, want)
    feasible = (want == args[0]).all(-1)
    assert feasible.any() and not feasible.all()       # both branches ran


def _serial_first_max(f, nvalid):
    """The one-thread kernel's scan: slot 0, then a strict > upward."""
    idx = []
    for j in range(f.shape[1]):
        best, at = f[0, j], 0
        for s in range(1, int(nvalid[j])):
            if f[s, j] > best:
                best, at = f[s, j], s
        idx.append(at)
    return torch.tensor(idx)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("group", [2, 8, 16, 32])
def test_warp_selection_is_the_serial_first_max(dtype, group):
    """Values from a few levels (ties everywhere), whole -inf stretches and
    all--inf pairs, every nvalid from 1 to m: every lane lands on the serial
    scan's slot and value."""
    rng = np.random.default_rng(group)
    m, n = 65, 200
    f = torch.as_tensor(rng.integers(-3, 3, (m, n)), dtype=dtype)
    f[rng.uniform(size=(m, n)) < 0.3] = -torch.inf
    f[:, :10] = -torch.inf
    f[:5, 10:20] = -torch.inf
    nvalid = torch.as_tensor(np.concatenate([np.arange(1, m + 1),
                                             rng.integers(1, m + 1, n - m)]))
    bf, bi = first_max_lanes(f, nvalid, group)
    want = _serial_first_max(f, nvalid)
    assert torch.equal(bi, want.expand(group, n))
    assert torch.equal(bf, f.gather(0, want[None]).expand(group, n))


def test_lanes_choice_on_the_cpu_is_the_plain_version():
    """The lanes argument picks a card schedule only: on CPU tensors every
    choice runs the plain version (no launch), and a lanes value the C
    entry does not take raises before anything runs.  The rule widens
    speculation where the batch leaves the card idle."""
    beta, h2, e = (x[:40] for x in _vertices(torch.float64)[1:])
    want = polyblock_solve_plain(beta, h2, e, CFG)
    before = polyblock_solve_fused.launches
    for lanes in LANES + (None,):
        for g, w in zip(polyblock_solve_fused(beta, h2, e, CFG, lanes=lanes), want):
            assert torch.equal(g, w)
    assert polyblock_solve_fused.launches == before
    with pytest.raises(ValueError, match="lanes"):
        polyblock_solve_fused(beta, h2, e, CFG, lanes=2)
    assert coop_lanes(883) == 16 and coop_lanes(116865) == 4


@pytest.mark.parametrize("n", [0, 1, 600, 4096, 1 << 18])
def test_project_lanes_is_a_schedule_the_kernel_takes(n):
    assert project_lanes(n) in PROJECT_LANES


def test_project_lanes_on_the_cpu_is_the_plain_version():
    """K2's lanes pick a card schedule only: on CPU tensors every choice runs
    `project_bisect` (no launch), and a lanes value the C entry does not
    take raises before anything runs."""
    args = [x[:40] for x in _vertices(torch.float64, pinned=False)]
    want = project_bisect(*args, CFG)
    before = polyblock_project.launches
    for lanes in PROJECT_LANES + (None,):
        assert torch.equal(polyblock_project(*args, CFG, lanes=lanes), want)
    assert polyblock_project.launches == before
    with pytest.raises(ValueError, match="lanes"):
        polyblock_project(*args, CFG, lanes=2)
