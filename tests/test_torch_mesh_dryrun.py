"""The dry run on the production mesh (`repro_torch.launch.dryrun` with
the fake process group of `launch.mesh.fake_mesh`), on the CPU:

  * the per-device argument bytes of every (arch x shape) on (16, 16) and
    (2, 16, 16) `==` the bytes the JAX package's rules imply
    (`param_shardings`, `opt_state_shardings`, `batch_shardings`,
    `cache_shardings` on an `AbstractMesh`, over `jax.eval_shape` of its
    parameters and optimizer state and its ShapeDtypeStructs): the sum over
    leaves of nbytes / the product of the axis sizes in the leaf's spec.
    Arguments only: no step runs;
  * the collectives counted on the fake (data=2, model=2) group equal
    those counted on a real four-rank gloo world running the same meshed
    train, prefill and serve steps (real tensors), op by op, call site by
    call site and byte for byte;
  * the fake group is scoped: `dryrun_one` leaves no process group behind,
    and the fake group refuses to start beside one;
  * `shard_tree`'s blocks own their storage;
  * no step gathers a parameter: on the fake 16x16 group every all-gather
    of the ten archs' train_4k (depth and sequence cut) and decode_32k
    (depth cut) steps is an activation, a gradient, the logits or
    Adafactor's state (its call site), and qwen2-7b's whole decode_32k
    step all-gathers activations only, under 0.1 GiB a device (13.17 GiB
    when every dense weight was gathered at use);
  * qwen2-7b at 2 layers, train_4k, on the fake 16x16 group keeps its peak
    of live intermediates under a bound derived from shapes (the case the
    layout of before failed by a wide margin: every weight gathered at the
    step's start, the logits whole over the vocab).
"""
from _torch_oracle import enable_x64  # noqa: F401,I001  (alias first)

import collections
import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

import _torch_ranks as R
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import specs as jax_specs
from repro.models.transformer import init_params as jax_init_params
from repro.sharding import partition as JP
from repro.train.optimizer import make_optimizer as jax_make_optimizer
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_mesh
from repro_torch.launch.multidevice_demo import init_world, spawn
from repro_torch.launch.step_analysis import collective_stats, tree_nbytes
from repro_torch.sharding.params import shard_tree
from repro_torch.sharding.partition import leaves_with_path

ARCH_NAMES = [a for a in ARCHS if not a.endswith("-smoke")]
MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}
GIB = 2**30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# argument bytes against the JAX rules
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _jax_params(arch: str, ep: int):
    cfg = jax_get_config(arch)
    return jax.eval_shape(functools.partial(jax_init_params, cfg, ep_size=ep),
                          jax.random.PRNGKey(0))


def _spec_bytes(tree, specs, shape: dict) -> int:
    """sum over leaves of nbytes / prod(sizes of the axes in its spec)."""
    total = 0
    for leaf, sharding in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: hasattr(x, "spec"))):
        n = math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize
        div = 1
        for entry in sharding.spec:
            for axis in ((entry,) if isinstance(entry, str) else tuple(entry or ())):
                div *= shape[axis]
        assert n % div == 0, (leaf.shape, sharding.spec)
        total += n // div
    return total


def _jax_argument_bytes(arch: str, shape_name: str, shape: dict) -> int:
    jcfg = jax_get_config(arch)
    jshape = JAX_SHAPES[shape_name]
    jcfg = jcfg.for_shape(jshape)
    mesh = AbstractMesh(tuple(shape.values()), tuple(shape))
    dp = tuple(a for a in shape if a != "model")
    params = _jax_params(arch, shape["model"])      # for_shape changes no parameter
    p_sh = JP.param_shardings(params, mesh)
    total = _spec_bytes(params, p_sh, shape)
    if jshape.kind == "train":
        opt_state = jax.eval_shape(jax_make_optimizer(jcfg.optimizer, 1e-4).init, params)
        total += _spec_bytes(opt_state, JP.opt_state_shardings(opt_state, p_sh, mesh), shape)
        batch = jax_specs.input_specs(jcfg, jshape)
    elif jshape.kind == "prefill":
        batch = jax_specs.input_specs(jcfg, jshape)
    else:
        batch = jax_specs.decode_input_specs(jcfg, jshape)
        cache = jax_specs.cache_specs(jcfg, jshape)
        total += _spec_bytes(cache, JP.cache_shardings(cache, mesh, dp), shape)
    return total + _spec_bytes(batch, JP.batch_shardings(batch, mesh, dp), shape)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_argument_bytes_equal_the_jax_rules(arch, mesh):
    """Every input shape of `arch` on `mesh`: rank 0's arguments
    (`dryrun.build_step` on the fake group) hold exactly the bytes per
    device the JAX package's shardings imply."""
    shape = MESHES[mesh]
    with fake_mesh(shape=shape) as dmesh:
        for shape_name, ishape in INPUT_SHAPES.items():
            cfg = get_config(arch).for_shape(ishape)
            ctx = dryrun.mesh_ctx(dmesh, ishape)
            _, args = dryrun.build_step(cfg, ishape, ctx=ctx)
            got = tree_nbytes(args)
            blocks = sum(t.nbytes for _, t in leaves_with_path(args)
                         if isinstance(t, torch.Tensor))
            assert got == blocks, (shape_name, "a block shares a storage")
            assert got == _jax_argument_bytes(arch, shape_name, shape), shape_name


# ---------------------------------------------------------------------------
# collectives: the fake group against a real gloo world
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m-smoke", "jamba-v0.1-52b-smoke",
                                  "deepseek-v3-671b-smoke"])
def test_fake_group_collectives_equal_a_gloo_world(arch):
    """The meshed train, prefill and serve steps' collectives on rank 0 of
    the fake (2, 2) group (meta tensors) == on every rank of four gloo
    processes (real tensors): each (op, call site, bytes) with its count,
    so every op's bytes and the total too."""
    cfg = get_config(arch)
    with fake_mesh(shape={"data": R.DATA, "model": R.MODEL}) as mesh:
        from repro_torch.sharding.ctx import ShardCtx
        fake = R.count_collectives(cfg, ShardCtx(mesh=mesh), "meta")
    assert not dist.is_initialized()
    real = spawn(R.collectives_rank, R.DATA * R.MODEL, (arch,), timeout=600)
    for step in ("train", "prefill", "decode"):
        assert fake[step], step
        for got in real:
            assert collections.Counter(got[step]) == collections.Counter(fake[step]), step
        stats = collective_stats(fake[step])
        assert stats["total"] > 0 and stats["total"] == stats["raw_total"]
    ops = {op for step in fake.values() for op, _, _ in step}
    assert {"all-gather", "all-reduce"} <= ops


# ---------------------------------------------------------------------------
# no parameter moves
# ---------------------------------------------------------------------------

# The call sites an all-gather may come from on a partitioned mesh: the
# layers' activations, a `sharding.comm` operator's backward (gradients),
# the vocab-parallel logits gathered for the caller, Adafactor's column
# moment.  A weight gathered at use would come from elsewhere.
ALL_GATHER_SITES = ("models.tensor_parallel.gather_cols < models.", "sharding.comm._",
                    "models.transformer.whole_logits", "train.optimizer.adafactor_sharded")
CUT_LAYERS = {"deepseek-v3-671b": 4, "jamba-v0.1-52b": 8}      # a dense prefix + MoE; a period


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_no_step_gathers_a_parameter(arch, shape_name):
    """Rank 0 of the fake 16x16 group at full width, cut to 2 layers (a
    period or a dense prefix where the arch has one; train at 64 tokens,
    the VLM at its 256 patches):
    every all-gather's call site is one of `ALL_GATHER_SITES`, and the
    step's layers are partitioned (some column- or row-parallel product
    ran)."""
    ishape, cfg = INPUT_SHAPES[shape_name], get_config(arch)
    if ishape.kind == "train":       # the VLM's prompt opens with its patches
        ishape = dataclasses.replace(ishape, seq_len=cfg.n_patches if cfg.use_mrope else 64)
    cfg = dataclasses.replace(cfg.for_shape(ishape), n_layers=CUT_LAYERS.get(arch, 2))
    with fake_mesh() as mesh:
        res = dryrun.analyze(cfg, ishape, ctx=dryrun.mesh_ctx(mesh, ishape))
    sites = {site for op, site, _ in res["collective_calls"] if op == "all-gather"}
    assert all(site.startswith(ALL_GATHER_SITES) for site in sites), sites
    assert not any("params" in site for _, site, _ in res["collective_calls"])
    assert any("row" in site or "_ColParallel" in site or "_RowScatter" in site
               for _, site, _ in res["collective_calls"])


def test_qwen2_7b_decode_all_gathers_activations_only():
    """qwen2-7b's whole decode_32k step on the fake 16x16 group: its 28 / 4
    heads split at 16 ranks, so each layer gathers its token's q, k, v
    (a few KiB); under 0.1 GiB of all-gather a device in all."""
    ishape = INPUT_SHAPES["decode_32k"]
    cfg = get_config("qwen2-7b").for_shape(ishape)
    with fake_mesh() as mesh:
        res = dryrun.analyze(cfg, ishape, ctx=dryrun.mesh_ctx(mesh, ishape))
    assert 0 < collective_stats(res["collective_calls"])["all-gather"] < 0.1 * GIB


# ---------------------------------------------------------------------------
# the fake group's scope
# ---------------------------------------------------------------------------

def test_dryrun_leaves_no_process_group_and_the_fake_group_refuses_one():
    res = dryrun.dryrun_one("whisper-base", "decode_32k", verbose=False)
    assert (res["mesh"], res["devices"]) == ("16x16", 256)
    assert res["collectives"]["total"] > 0
    assert not dist.is_initialized()
    init_world(0, 1, "gloo")
    try:
        with pytest.raises(RuntimeError, match="already exists"):
            with fake_mesh():
                pass
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# shard_tree's blocks
# ---------------------------------------------------------------------------

def test_shard_tree_blocks_own_their_storage():
    """A dim-0 block of a contiguous tensor is a view into the whole
    storage; `shard_tree` keeps a copy of it alone (a (16, 4) float32
    leaf's block 0 of 4: 64 bytes, not 256), so the whole leaf can go."""
    tree = {"a": torch.arange(64, dtype=torch.float32).reshape(16, 4),
            "b": torch.ones(4, 8), "c": torch.zeros(3)}
    specs = {("a",): ("model", None), ("b",): (None, "model"), ("c",): (None,)}
    with fake_mesh(shape={"data": 1, "model": 4}) as mesh:
        blocks = shard_tree(tree, specs, mesh)
    assert blocks["a"].untyped_storage().nbytes() == blocks["a"].nbytes == 64
    torch.testing.assert_close(blocks["a"], tree["a"][:4])
    assert blocks["b"].shape == (4, 2) and blocks["c"] is tree["c"]
    assert tree_nbytes(blocks) == sum(t.nbytes for t in blocks.values())


# ---------------------------------------------------------------------------
# the peak of live intermediates
# ---------------------------------------------------------------------------

def test_qwen2_7b_two_layers_temp_under_its_shape_bound():
    """qwen2-7b cut to 2 layers, train_4k, on the fake 16x16 group with
    attention sharded over `model` (attn_shard="explicit": its scores are
    1 / 16 of the layer's; under "auto" attention runs whole on every
    model rank, which the dry run reports).  The peak of live
    intermediates stays under, from shapes (per device, B = 16 rows of
    S = 4096 tokens):
      the logits' vocab block, (B, S, V / 16), in bf16 and three float32
      working copies;
      one sublayer's weights gathered whole, and their whole gradient;
      the saved sublayer inputs under remat, n_layers x (B, S, d) bf16;
      a margin of 10 of the recomputed sublayer's widest activations,
      (B, S, ffn) bf16, its working set with attention partitioned.
    The layout before this bound (every dense weight gathered at the
    step's start and the logits whole over the vocab: one float32 copy of
    them is 37 GiB) passes none of it."""
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=2)
    ishape = INPUT_SHAPES["train_4k"]
    b, s, mp = ishape.global_batch // 16, ishape.seq_len, 16
    logits = b * s * (cfg.vocab // mp) * (2 + 3 * 4)
    layer = sum(t.numel() for _, t in leaves_with_path(
        dryrun.param_shapes(cfg)["s0_l0"][0])) * 2 * 2
    saved = cfg.n_layers * b * s * cfg.d_model * 2
    margin = 10 * b * s * cfg.ffn_dense * 2
    bound = logits + layer + saved + margin
    with fake_mesh() as mesh:
        res = dryrun.analyze(cfg, ishape, ctx=dryrun.mesh_ctx(mesh, ishape, "explicit"))
    assert res["temp_size_in_bytes"] < bound, (res["temp_size_in_bytes"] / GIB, bound / GIB)
    assert bound < 40 * GIB


@pytest.mark.parametrize("arch", ["stablelm-3b", "qwen1.5-110b"])
def test_decode_cache_per_device_is_a_sixteenth_of_the_data_shard(arch):
    """decode_32k on the fake 16x16 group: the cache rank 0 holds is its
    block of the cache length (`cache_shardings`), a 16th of its data
    shard's whole cache (the layout before: 80 GiB per device) but for
    the ring positions and write index every rank keeps whole; at most
    5.1 GiB."""
    ishape = INPUT_SHAPES["decode_32k"]
    cfg = get_config(arch).for_shape(ishape)
    with fake_mesh() as mesh:
        _, (_, _, cache) = dryrun.build_step(cfg, ishape, ctx=dryrun.mesh_ctx(mesh, ishape))
    whole = dryrun.cache_specs(cfg, ishape)
    kv = {"k", "v"}
    data_shard = sum(t.nbytes for path, t in leaves_with_path(whole) if path[-1] in kv) // 16
    held = sum(t.nbytes for path, t in leaves_with_path(cache) if path[-1] in kv)
    assert data_shard == 80 * GIB
    assert held * 16 == data_shard and tree_nbytes(cache) <= 5.1 * GIB


def test_collective_bytes_follow_the_jax_convention():
    """`CollectiveBytes` prices each collective by its result on this
    device, as `hlo_analysis` prices an HLO collective by its output shape:
    an all-reduce its tensor, an all-gather the gathered tensor, a
    reduce-scatter the scattered block, an all-to-all its output; a
    broadcast counts under "collective-permute"; `detail` lists (op,
    bytes, calls, site)."""
    import torch.distributed._functional_collectives as fc

    from repro_torch.launch.step_analysis import CollectiveBytes

    x = torch.empty(4, 8, device="meta")                # 128 bytes
    with fake_mesh(shape={"data": 1, "model": 4}) as mesh:
        g = mesh.get_group("model")
        with CollectiveBytes() as counted:
            dist.all_reduce(x, group=g)
            dist.all_gather([torch.empty_like(x) for _ in range(4)], x, group=g)
            dist.all_gather_into_tensor(torch.empty(16, 8, device="meta"), x, group=g)
            dist.reduce_scatter_tensor(torch.empty(1, 8, device="meta"),
                                       torch.empty(4, 8, device="meta"), group=g)
            dist.all_to_all_single(torch.empty(4, 8, device="meta"), x, group=g)
            dist.broadcast(x, 0, group=g)
            fc.all_reduce(x, "sum", g)
    stats = collective_stats(counted.calls, detail=True)
    assert stats["all-reduce"] == 128 + 128
    assert stats["all-gather"] == 512 + 512
    assert stats["reduce-scatter"] == 32
    assert stats["all-to-all"] == 128 and stats["collective-permute"] == 128
    assert stats["count"] == 7 and stats["total"] == stats["raw_total"] == 1568
    # Both all-gathers come from one call site (outside the package: "?")
    # with one size, so they are one entry of two calls.
    assert stats["top"][0] == ("all-gather", 1024, 2, "?")
    assert collective_stats() == {**{k: 0 for k in stats if k != "top"}}
