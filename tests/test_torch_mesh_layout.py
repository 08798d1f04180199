"""The meshed model's optimizer in the sharding rules' layout, on four gloo
ranks as (data=2, model=2): Adafactor's meshed form
(`train.optimizer.adafactor_sharded`, what `make_train_step(ctx=)` runs
for an optimizer whose statistics span a leaf) against the unsharded
Adafactor step from the same float32 weights on the same batch.  Its
state is held as `opt_state_shardings` lays it out (the JAX package's
mirroring rule: a factored moment takes its parameter's spec without the
last dim), which the dry run's argument bytes rest on; the row and column
means and the update's RMS are summed over `model`, so the steps agree up
to summation order.
"""
from _torch_oracle import enable_x64  # noqa: F401,I001  (alias first)

import numpy as np
import pytest
import torch

import _torch_ranks as R
from repro_torch.configs import get_config
from repro_torch.launch.multidevice_demo import spawn
from repro_torch.models import transformer as TT
from repro_torch.sharding import partition as TP
from repro_torch.sharding.params import model_block, paired
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import make_grad_fn, make_train_step

LR, STEPS = 1e-2, 2
SLACK_CAP = 1e-3        # an element's extra allowance for its gradient's error, in lr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _block(leaf: np.ndarray, spec: tuple, data: int, model: int, path: tuple = ()) -> np.ndarray:
    """The (data, model) rank's block of a whole leaf under `spec` (on
    `model` the paired block where `path` is a paired leaf, as
    `shard_tree` keeps it)."""
    for dim, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else tuple(entry or ())):
            if axis == "data":
                leaf = np.split(leaf, R.DATA, axis=dim)[data]
            else:
                leaf = model_block(torch.from_numpy(leaf), dim, R.MODEL, model,
                                   paired(path)).numpy()
    return leaf


def _f64(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().astype(np.float64)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b-smoke", "deepseek-v3-671b-smoke"])
def test_meshed_adafactor_matches_the_unsharded_step(arch):
    """Two meshed Adafactor steps (lr 1e-2) on float32 copies of the
    weights against two unsharded steps: the losses within 1e-5, every
    parameter block within 1e-3 lr of the unsharded one's block (an update
    moves a parameter by up to lr) plus, per element, lr times its
    gradient's float32 error over the element (1e-5 of the leaf's largest
    gradient over |g|, each step), that extra at most SLACK_CAP: the
    partitioned layers sum in another order than the unsharded GEMMs, and
    Adafactor normalises each element by its own statistic (jamba's last
    ln2.g has an element whose second gradient is 3.1e-6 against a median
    of 1.3e-3: 1.043e-3 lr apart, where the unsharded float32 step is
    itself 6.2e-4 lr from the same steps in float64), every state leaf
    (step count, row and column moments, in their `opt_state_shardings`
    blocks) within 1e-4 of its scale."""
    cfg = get_config(arch)
    assert cfg.optimizer == "adafactor"
    params = TT._tree_map(lambda t: t.float(),
                          TT.init_params(cfg, torch.Generator().manual_seed(0), ep_size=R.MODEL))
    rng = np.random.default_rng(3)
    b, s = 4, 8
    tokens = rng.integers(0, cfg.vocab, (b, s + 1))
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]),
             "labels": torch.from_numpy(tokens[:, 1:]),
             "fl_weights": torch.from_numpy(rng.uniform(0.5, 2.0, b).astype(np.float32))}
    outs = spawn(R.adafactor_rank, R.DATA * R.MODEL, (arch, params, batch, LR, STEPS),
                 timeout=600)

    opt = make_optimizer("adafactor", LR)
    step = make_train_step(cfg, opt, remat=False)
    want, state, losses, slack = params, opt.init(params), [], None
    paths = [path for path, _ in TP.leaves_with_path(params)]
    for _ in range(STEPS):
        grads = make_grad_fn(cfg, remat=False)(want, batch)[0]
        # Adafactor divides each element's gradient by its RMS statistic, so
        # an element's update moves with its gradient's float32 error, held
        # to 1e-5 of the leaf's scale (tests/test_torch_tensor_parallel.py)
        # over the element: 1e-5 max|g| / |g| a step.
        s = {p: 1e-5 * float(g.abs().max()) / np.maximum(_f64(g.abs()), 1e-30)
             for p, g in zip(paths, grads)}
        slack = s if slack is None else {p: slack[p] + s[p] for p in paths}
        want, state, m = step(want, state, batch)
        losses.append(float(m["loss"]))
    mesh = {"data": R.DATA, "model": R.MODEL}
    p_specs = TT.param_specs(cfg, mesh, R.MODEL)
    s_specs = TP.opt_state_shardings(state, TT.param_shapes(cfg, ep_size=R.MODEL), mesh)
    n_moved = 0
    for o in outs:
        np.testing.assert_allclose(o["losses"], losses, rtol=1e-5)
        for path, leaf in TP.leaves_with_path(want):
            block = _block(_f64(leaf), p_specs[path], o["data"], o["model"], path)
            start = _block(_f64(_leaf(params, path)), p_specs[path], o["data"], o["model"],
                           path)
            got = o["params"][path]
            assert got.shape == block.shape, path
            extra = _block(slack[path], p_specs[path], o["data"], o["model"], path)
            limit = LR * (1e-3 + np.minimum(extra, SLACK_CAP))
            assert np.all(np.abs(got - block) <= limit), (path, np.abs(got - block).max())
            n_moved += int(np.abs(block - start).max() > 0.1 * LR)
        for path, leaf in TP.leaves_with_path(state):
            block = _block(_f64(leaf), s_specs[path], o["data"], o["model"])
            got = o["state"][path]
            assert got.shape == block.shape, path
            assert np.abs(got - block).max() <= 1e-4 * max(np.abs(block).max(), 1e-30), path
    assert n_moved > 0
    assert any("model" in spec for spec in s_specs.values())


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree
