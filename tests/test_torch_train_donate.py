"""The donated train step of the PyTorch port (`make_train_step(donate=True)`,
the counterpart of the JAX package's `donate_argnums=(0, 1)`), on the CPU.

  * Three steps of the donated step are bitwise three steps of the
    functional one (`donate=False`) for sgd, momentum, adam and adamw,
    from `opt.init` (whose adam state hands one zero tree to both
    moments): every parameter, both moments, the count and the metrics, on
    the smoke configs of qwen2-7b, deepseek-v3-671b (MLA, MoE, the MTP
    head), jamba-v0.1-52b (Mamba, MoE), whisper-base (the encoder and
    cross-attention) and qwen2-vl-2b (M-RoPE, the patch splice).  The
    parameters are updated in their own storage; the moments end in
    storage of their own.
  * A chain has no in-place update: a donated step with one raises.
    (Adafactor's donated update: `tests/test_torch_adafactor_donate.py`.)
  * `train_loop`, which donates, gives the functional step's traces to
    the bit.
  * On the meta device (`launch.dryrun`), the donated step's predicted peak
    against the functional one's at the four card runs' depth and shape.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import InputShape, get_config
from repro_torch.data.pipeline import synthetic_token_batch
from repro_torch.launch import dryrun
from repro_torch.launch import train as TL
from repro_torch.launch.serve import stub_frontend
from repro_torch.launch.step_analysis import tree_nbytes
from repro_torch.models.transformer import init_params
from repro_torch.train import optimizer as TO
from repro_torch.train.train_step import make_train_step
from repro_torch.train.tree import tree_leaves

ARCHS = ["qwen2-7b-smoke", "deepseek-v3-671b-smoke", "jamba-v0.1-52b-smoke",
         "whisper-base-smoke", "qwen2-vl-2b-smoke"]
OPTS = ["sgd", "momentum", "adam", "adamw"]
# The card runs of chip_smoke.py's training phase: (arch, layers, seq), batch 8.
CARD_RUNS = [("deepseek-v3-671b", 3, 128), ("jamba-v0.1-52b", 2, 128),
             ("whisper-base", 6, 128), ("qwen2-vl-2b", 28, 512)]
CARD_GIB = 72          # room under the 79.6 GiB an 80 GB H100 gives torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(cfg, seed, b=2, s=32):
    t = synthetic_token_batch(np.random.default_rng(seed), b, s, cfg.vocab)
    return {"tokens": torch.from_numpy(t["tokens"]), "labels": torch.from_numpy(t["labels"]),
            "fl_weights": torch.tensor([1.5, 0.5]), **stub_frontend(cfg, b, s, "cpu")}


def _state_leaves(state) -> list:
    return torch.utils._pytree.tree_leaves(state)


def _run(arch, opt_name, donate, steps=3):
    cfg = get_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    opt = TO.make_optimizer(opt_name, 1e-2)
    state = opt.init(params)
    step = make_train_step(cfg, opt, remat=False, donate=donate)
    first = tree_leaves(params)
    metrics = []
    for i in range(steps):
        out, state, m = step(params, state, _batch(cfg, i))
        if donate:
            assert out is params
            assert all(a is b for a, b in zip(tree_leaves(out), first))
        params = out
        metrics.append(m)
    return params, state, metrics


@pytest.mark.parametrize("opt_name", OPTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_donated_step_is_bitwise_the_functional_step(arch, opt_name):
    p0, s0, m0 = _run(arch, opt_name, donate=False)
    p1, s1, m1 = _run(arch, opt_name, donate=True)
    for a, b in zip(tree_leaves(p0), tree_leaves(p1), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    l0, l1 = _state_leaves(s0), _state_leaves(s1)
    assert len(l0) == len(l1)
    for a, b in zip(l0, l1):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(m0, m1):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    if opt_name.startswith("adam"):
        assert int(s1.count) == 3
        mu = {t.untyped_storage().data_ptr() for t in tree_leaves(s1.mu)}
        assert not mu & {t.untyped_storage().data_ptr() for t in tree_leaves(s1.nu)}


@pytest.mark.parametrize("opt", [TO.chain(TO.clip_by_global_norm(1.0), TO.sgd(0.1))],
                         ids=["chain"])
def test_donated_step_refuses_an_optimizer_that_is_not_elementwise(opt):
    cfg = get_config("qwen2-7b-smoke")
    with pytest.raises(ValueError, match="donate=True"):
        make_train_step(cfg, opt, donate=True)
    make_train_step(cfg, opt, donate=False)


@pytest.mark.parametrize("arch", ["qwen2-7b-smoke", "jamba-v0.1-52b-smoke"])
def test_train_loop_traces_are_the_functional_steps(arch, monkeypatch):
    """train_loop donates; the same loop on make_train_step(donate=False)
    gives its loss and grad-norm traces to the bit."""
    kw = dict(steps=3, batch=2, seq=32, fl=True, device="cpu", log_every=3)
    got = TL.train_loop(arch, **kw)
    real = TL.make_train_step
    monkeypatch.setattr(TL, "make_train_step",
                        lambda *a, **k: real(*a, **{**k, "donate": False}))
    want = TL.train_loop(arch, **kw)
    assert got.losses == want.losses and got.grad_norms == want.grad_norms


def _predicted_peak(cfg, seq, donate) -> int:
    shape = InputShape("train", seq, 8, "train")
    kw = dict(opt=TO.adamw(3e-4), remat=False, donate=donate)
    args = tree_nbytes(dryrun.build_step(cfg, shape, **kw)[1])
    return args + dryrun.analyze(cfg, shape, **kw)["temp_size_in_bytes"]


@pytest.mark.parametrize("arch,layers,seq", CARD_RUNS)
def test_donated_peak_fits_the_card_and_is_at_most_the_functional_one(arch, layers, seq):
    """The meta dry run of each card training run: the donated step's peak
    under CARD_GIB and no higher than the functional step's.  Where the
    functional peak is the update (the old and the new parameters and
    moments at once) the donated one is lower; whisper-base's peak is in
    the backward pass (the encoder's saved attention over 8 x 1 500
    frames, 8.55 GiB of 9.58), which donation does not touch."""
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    donated = _predicted_peak(cfg, seq, True)
    functional = _predicted_peak(cfg, seq, False)
    assert donated < CARD_GIB * 2**30
    if arch == "whisper-base":
        assert donated == functional
    else:
        assert donated < functional


def test_dry_run_donates_where_the_optimizer_updates_in_place():
    """build_step's default: donated with AdamW (functional peak above the
    donated one) and with Adafactor (deepseek-v3-671b's optimizer), as the
    JAX dry run donates for every optimizer."""
    cfg = get_config("qwen2-7b-smoke")
    shape = InputShape("train", 32, 2, "train")
    adam = {d: dryrun.analyze(cfg, shape, opt=TO.adamw(1e-3), donate=d)["temp_size_in_bytes"]
            for d in (None, True, False)}
    assert adam[None] == adam[True] < adam[False]
    ds = get_config("deepseek-v3-671b-smoke")
    assert ds.optimizer == "adafactor"
    factor = {d: dryrun.analyze(ds, shape, donate=d)["temp_size_in_bytes"]
              for d in (None, True, False)}
    assert factor[None] == factor[True] < factor[False]
