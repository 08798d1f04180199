"""Adafactor's donated update (`make_train_step(donate=True)` with
Adafactor: `train.optimizer`'s two passes over chunks of each leaf), on the
CPU.

  * Three donated Adafactor steps are bitwise three functional ones
    (`donate=False`) from `opt.init` on the smoke configs of qwen2-7b,
    deepseek-v3-671b, jamba-v0.1-52b, whisper-base and qwen2-vl-2b: every
    parameter, both moments, the count and the metrics; the parameters are
    updated in their own storage.  Once more on deepseek-v3-671b-smoke with
    the chunk bound (`optimizer.CHUNK_ELEMENTS`) so small that layers,
    expert blocks and the global norm's runs split into several chunks:
    bitwise as well; one float32 update there has the default bound's
    moments to the bit and its update within 1e-6 (the clip's sum in
    another order).
  * On gloo ranks as (data=1, model=2) and (data=2, model=2), the second
    with small chunks (`_torch_ranks.adafactor_donate_rank`): two meshed
    donated Adafactor steps bitwise the meshed functional steps on
    jamba-v0.1-52b-smoke and deepseek-v3-671b-smoke; the two forms'
    collectives the same (op, call site, bytes, calls), and the bytes of
    Adafactor's own ("train.optimizer.adafactor_sharded") those the
    unchunked update moved, derived here from the shapes and the specs: per
    leaf the row sums, column sums and the row moment's mean where its last
    two dims are sharded, the column moment moved both ways, and one
    float32 sum of squares.  Chunking changes the number of calls (one per
    chunk where a leaf's last two dims are sharded), not their bytes.
  * On the meta device (`launch.dryrun`): the donated Adafactor's
    predicted temp below the functional one's on deepseek-v3-671b-smoke;
    at the card runs' shape (batch 8, seq 128), deepseek-v3-671b at 4
    layers (its first MoE layer) and jamba-v0.1-52b at 5 (its attention
    layer): the donated peak (arguments + temp) below the functional one's
    and under CARD_GIB.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import _torch_ranks as R
from repro_torch.configs import InputShape, get_config
from repro_torch.data.pipeline import synthetic_token_batch
from repro_torch.launch import dryrun
from repro_torch.launch.multidevice_demo import spawn
from repro_torch.launch.serve import stub_frontend
from repro_torch.launch.step_analysis import tree_nbytes
from repro_torch.models import transformer as TT
from repro_torch.models.transformer import init_params
from repro_torch.sharding.partition import leaves_with_path
from repro_torch.train import optimizer as TO
from repro_torch.train.train_step import make_train_step
from repro_torch.train.tree import jax_leaves, tree_leaves

ARCHS = ["qwen2-7b-smoke", "deepseek-v3-671b-smoke", "jamba-v0.1-52b-smoke",
         "whisper-base-smoke", "qwen2-vl-2b-smoke"]
# Chunk bounds (elements) under deepseek-v3-671b-smoke's (4, 256, 128)
# expert leaves: runs of 2 experts on one device, one expert a chunk of a
# rank's (2, 256, 128) block at model 2.
SMALL_CHUNK = 1 << 16
MESH_CHUNK = 1 << 14
CARD_GIB = 72          # room under the 79.6 GiB an 80 GB H100 gives torch
SITE = "train.optimizer.adafactor_sharded"


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


def _run(arch, donate, steps=3):
    cfg = get_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    opt = TO.make_optimizer("adafactor", 1e-2)
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


def _assert_bitwise(a, b):
    (p0, s0, m0), (p1, s1, m1) = a, b
    for x, y in zip(tree_leaves(p0), tree_leaves(p1), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)
    l0, l1 = torch.utils._pytree.tree_leaves(s0), torch.utils._pytree.tree_leaves(s1)
    assert len(l0) == len(l1)
    for x, y in zip(l0, l1):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for x, y in zip(m0, m1):
        assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
    assert int(s1.count) == len(m1)


@pytest.mark.parametrize("arch", ARCHS)
def test_donated_adafactor_is_bitwise_the_functional_step(arch):
    _assert_bitwise(_run(arch, donate=False), _run(arch, donate=True))


def _f32_update(params, seed: int):
    """One functional Adafactor update of float32 `params` from its init
    with a seeded float32 gradient: (updates, state)."""
    gen = torch.Generator().manual_seed(seed)
    grads = TT._tree_map(lambda p: torch.randn(p.shape, generator=gen), params)
    opt = TO.adafactor(1e-2)
    return opt.update(grads, opt.init(params), params)


def test_small_chunks_split_layers_and_experts(monkeypatch):
    arch = "deepseek-v3-671b-smoke"
    params = init_params(get_config(arch), torch.Generator().manual_seed(0))
    f32 = TT._tree_map(lambda t: t.float(), params)
    default = _f32_update(f32, 1)
    monkeypatch.setattr(TO, "CHUNK_ELEMENTS", SMALL_CHUNK)
    shape = lambda leaf: ((len(leaf),) + tuple(leaf[0].shape)  # noqa: E731
                          if isinstance(leaf, list) else tuple(leaf.shape))
    chunks = {path: TO._chunks(shape(leaf), isinstance(leaf, list))
              for path, leaf in jax_leaves(params)}
    layers = {path: len(leaf) for path, leaf in jax_leaves(params) if isinstance(leaf, list)}
    # Some group's layers each split into several chunks, and some by runs
    # of experts (a slice on the expert dim).
    assert any(len(c) > layers.get(path, 1) for path, c in chunks.items())
    assert any(isinstance(k, slice) for c in chunks.values() for idx in c for k in idx)
    assert any(math.prod(t.shape) > SMALL_CHUNK for t in tree_leaves(params))
    _assert_bitwise(_run(arch, donate=False), _run(arch, donate=True))
    # The moments are exact per chunk: the same bits at either bound; the
    # update differs by the clip's sum order alone.
    upd, state = _f32_update(f32, 1)
    for x, y in zip(torch.utils._pytree.tree_leaves(state),
                    torch.utils._pytree.tree_leaves(default[1]), strict=True):
        assert torch.equal(x, y)
    for x, y in zip(tree_leaves(upd), tree_leaves(default[0]), strict=True):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=0)


def _whole_batch(cfg, seed, b=4, s=8):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s + 1))
    return {"tokens": torch.from_numpy(tokens[:, :-1]),
            "labels": torch.from_numpy(tokens[:, 1:]),
            "fl_weights": torch.from_numpy(rng.uniform(0.5, 2.0, b).astype(np.float32))}


def _adafactor_bytes(cfg, data: int, model: int) -> dict:
    """{op: bytes} one meshed Adafactor update moves on a rank, from the
    shapes and specs alone (float32): for each stacked leaf of whole shape
    W, block B and spec P with two dims or more, the row sums (all-reduce,
    B[:-1]) where P[-1] shards W[-1]; the column moment gathered to the
    block's layout (all-gather, B[:-2] + W[-1:]), the column sums (B[:-2] +
    B[-1:]) and the row moment's mean (B[:-2]) where P[-2] shards W[-2];
    the new column moment gathered back (B[:-2] + W[-1:]) where P[-1]
    shards; and one sum of squares where any dim is sharded."""
    mesh = {"data": data, "model": model}
    specs = TT.param_specs(cfg, mesh, model)
    stacked = {}
    for path, leaf in leaves_with_path(TT.param_shapes(cfg, ep_size=model)):
        jpath = tuple(str(k) for k in path if not isinstance(k, int))
        n_stack = sum(isinstance(k, int) for k in path)
        reps = stacked[jpath][2] + 1 if jpath in stacked else 1
        stacked[jpath] = (tuple(leaf.shape), (None,) * n_stack + specs[path], reps)
    out = {"all-reduce": 0, "all-gather": 0}
    for shape, spec, reps in stacked.values():
        w = ((reps,) if len(spec) > len(shape) else ()) + shape
        b = tuple(n // (model if e == "model" else 1) for n, e in zip(w, spec))
        if len(w) >= 2:
            lead = math.prod(b[:-2])
            if spec[-1] is not None:
                out["all-reduce"] += 4 * lead * b[-2]
                out["all-gather"] += 4 * lead * w[-1]
            if spec[-2] is not None:
                out["all-gather"] += 4 * lead * w[-1]
                out["all-reduce"] += 4 * (lead * b[-1] + lead)
        if any(e is not None for e in spec):
            out["all-reduce"] += 4
    return out


def _by_site(calls: dict) -> dict:
    out = {}
    for (op, site, nbytes), n in calls.items():
        out[(op, site)] = out.get((op, site), 0) + nbytes * n
    return out


@pytest.mark.parametrize("data,model,chunk", [(1, 2, None), (2, 2, MESH_CHUNK)],
                         ids=["1x2", "2x2-small-chunks"])
def test_meshed_donated_adafactor_is_bitwise_the_meshed_functional_step(data, model, chunk):
    steps = 2
    cases = []
    for arch in ("jamba-v0.1-52b-smoke", "deepseek-v3-671b-smoke"):
        cfg = get_config(arch)
        assert cfg.optimizer == "adafactor"
        params = TT._tree_map(lambda t: t.float(),
                              init_params(cfg, torch.Generator().manual_seed(0), ep_size=model))
        cases.append((arch, params, _whole_batch(cfg, 3)))
    outs = spawn(R.adafactor_donate_rank, data * model, (cases, data, model, 1e-2, steps, chunk),
                 timeout=600)
    for i, (arch, _, _) in enumerate(cases):
        want = {op: steps * n for op, n in _adafactor_bytes(get_config(arch), data,
                                                            model).items()}
        assert want["all-reduce"] and want["all-gather"]
        for rank_out in outs:
            o = rank_out[i]
            assert o["bitwise"], (arch, data, model)
            assert o["moved"] > 0 and o["count"] == steps
            assert o["calls"][True] == o["calls"][False]
            got = _by_site(o["calls"][True])
            assert {op: got.get((op, SITE), 0) for op in want} == want, arch
            assert {op for op, site in got if site == SITE} <= set(want)


def _meta_peak(cfg, shape, donate) -> tuple[int, int]:
    kw = dict(opt=TO.adafactor(3e-4), remat=False, donate=donate)
    return (tree_nbytes(dryrun.build_step(cfg, shape, **kw)[1]),
            dryrun.analyze(cfg, shape, **kw)["temp_size_in_bytes"])


def test_donated_adafactor_temp_is_below_the_functional_one():
    cfg = get_config("deepseek-v3-671b-smoke")
    shape = InputShape("train", 32, 2, "train")
    args, donated = _meta_peak(cfg, shape, True)
    assert (args, donated) > (0, 0)
    assert donated < _meta_peak(cfg, shape, False)[1]


@pytest.mark.parametrize("arch,layers", [("deepseek-v3-671b", 4), ("jamba-v0.1-52b", 5)])
def test_donated_adafactor_fits_the_card(arch, layers):
    """At batch 8, seq 128: deepseek-v3-671b's first MoE layer (its 4th)
    and jamba-v0.1-52b's attention layer (its 5th), which no optimizer
    trained on one card before Adafactor was donated."""
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    assert cfg.optimizer == "adafactor"
    shape = InputShape("train", 128, 8, "train")
    donated = sum(_meta_peak(cfg, shape, True))
    assert donated < sum(_meta_peak(cfg, shape, False))
    assert donated < CARD_GIB * 2**30
