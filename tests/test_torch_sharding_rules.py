"""The sharding rules of the port (`repro_torch.sharding.partition`) `==`
the JAX package's (`repro.sharding.partition`), at production meshes no
machine here has: the rules read only a mesh's shape, so the JAX side runs
on the `_FakeMesh` pattern of tests/test_sharding_and_launch.py (for
`param_spec`) or a `jax.sharding.AbstractMesh` (where `NamedSharding`
needs a mesh), and the port on {axis: size}.

  * `param_spec` on every leaf of all ten archs' full-size parameter trees
    (`jax.eval_shape(init_params)`), at (16, 16), (2, 16, 16) and (4, 2),
    with ep_size 1 and 16; and `param_shardings` over the port's own tree
    (`param_shapes` on the meta device), a per-layer group's leaf holding
    the stacked spec without its leading dim;
  * `opt_state_shardings` for AdamW (count, mu, nu) and Adafactor (count
    and the stacked factored row / col moments, which take the JAX
    package's mirroring rule as it is);
  * `cache_shardings` on every decode shape's cache, `batch_shardings` on
    every input shape's batch;
  * `placements` on a (1, 1) gloo mesh of one rank: Shard(d) on the mesh
    dim a spec names, Replicate() elsewhere.
"""
from _torch_oracle import enable_x64  # noqa: F401,I001  (alias first)

import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import specs as jax_specs
from repro.models.transformer import init_params as jax_init_params
from repro.sharding import partition as JP
from repro.train.optimizer import make_optimizer as jax_make_optimizer
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch import specs as port_specs
from repro_torch.models.transformer import param_shapes
from repro_torch.sharding import partition as TP
from repro_torch.train.optimizer import make_optimizer

ARCH_NAMES = [a for a in ARCHS if not a.endswith("-smoke")]
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2}}


class _FakeMesh:
    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _abstract(shape: dict) -> AbstractMesh:
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _dp(shape: dict) -> tuple:
    return tuple(a for a in shape if a != "model")


def _key(k):
    """A JAX path entry as the port's path names it."""
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _jax_flat(tree, spec_of) -> dict:
    return {tuple(_key(k) for k in path): spec_of(path, leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _port_vs_jax(port: dict, jax_by_path: dict):
    """Every port leaf's spec == the JAX leaf's (for a per-layer group's
    leaf: the stacked JAX spec without its leading dim); both trees have
    the same leaves."""
    seen = set()
    for path, spec in port.items():
        jpath = tuple(str(k) for k in path if not isinstance(k, int))
        n_stack = sum(isinstance(k, int) for k in path)
        want = jax_by_path[jpath]
        assert P(*spec) == P(*tuple(want)[n_stack:]), (path, spec, want)
        seen.add(jpath)
    assert seen == set(jax_by_path)


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str, ep: int):
    cfg = jax_get_config(arch)
    return jax.eval_shape(lambda: jax_init_params(cfg, jax.random.PRNGKey(0), ep_size=ep))


@functools.lru_cache(maxsize=None)
def _port_params(arch: str, ep: int):
    return param_shapes(get_config(arch), ep_size=ep)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_spec_equals_the_jax_rules(arch, mesh):
    shape = MESHES[mesh]
    for ep in (1, 16):
        jp = _jax_params(arch, ep)
        want = _jax_flat(jp, lambda path, leaf: JP.param_spec(path, leaf, _FakeMesh(shape)))
        for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
            names = tuple(_key(k) for k in path)
            assert P(*TP.param_spec(names, leaf.shape, shape)) == want[names], names
        _port_vs_jax(TP.param_shardings(_port_params(arch, ep), shape), want)


def test_rules_shard_what_the_production_mesh_divides():
    """Spot checks of the rules' outcomes at (16, 16): granite's 40 experts
    pad to 48 and shard, whisper's 51865 vocabulary stays replicated."""
    shape = MESHES["16x16"]
    granite = TP.param_shardings(_port_params("granite-moe-3b-a800m", 16), shape)
    gate = [s for p, s in granite.items() if p[-2:] == ("moe", "gate")]
    assert gate and all(s == ("model", None, None) for s in gate)
    whisper = TP.param_shardings(_port_params("whisper-base", 1), shape)
    assert whisper[("embed", "w")] == (None, None)
    qwen = TP.param_shardings(_port_params("qwen2-7b", 1), shape)
    assert qwen[("s0_l0", 0, "attn", "wq", "w")] == (None, "model")
    assert qwen[("s0_l0", 0, "attn", "wo", "w")] == ("model", None)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_opt_state_shardings_equal_the_jax_rules(arch, opt_name):
    jp = _jax_params(arch, 16)
    tp = _port_params(arch, 16)
    jstate = jax.eval_shape(jax_make_optimizer(opt_name, 1e-3).init, jp)
    tstate = make_optimizer(opt_name, 1e-3).init(tp)
    for shape in MESHES.values():
        amesh = _abstract(shape)
        p_sh = JP.param_shardings(jp, amesh)
        want = {path: s.spec for path, s in
                _jax_flat(JP.opt_state_shardings(jstate, p_sh, amesh),
                          lambda path, leaf: leaf).items()}
        _port_vs_jax(TP.opt_state_shardings(tstate, tp, shape), want)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_and_batch_shardings_equal_the_jax_rules(arch, mesh):
    shape = MESHES[mesh]
    amesh, dp = _abstract(shape), _dp(shape)
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    for name, ishape in INPUT_SHAPES.items():
        jshape = JAX_SHAPES[name]
        jbatch = jax_specs.input_specs(jcfg, jshape)
        want = _jax_flat(JP.batch_shardings(jbatch, amesh, dp), lambda p, s: s.spec)
        _port_vs_jax(TP.batch_shardings(port_specs.input_specs(tcfg, ishape), shape, dp), want)
        if ishape.kind != "decode":
            continue
        jdec = jax_specs.decode_input_specs(jcfg, jshape)
        want = _jax_flat(JP.batch_shardings(jdec, amesh, dp), lambda p, s: s.spec)
        _port_vs_jax(TP.batch_shardings(port_specs.decode_input_specs(tcfg, ishape), shape,
                                        dp), want)
        jcache = jax_specs.cache_specs(jcfg, jshape)
        want = _jax_flat(JP.cache_shardings(jcache, amesh, dp), lambda p, s: s.spec)
        _port_vs_jax(TP.cache_shardings(port_specs.cache_specs(tcfg, ishape), shape, dp),
                     want)


def test_placements_on_a_device_mesh():
    """A spec as DTensor placements: Shard(d) on the mesh dim that names
    it, Replicate() elsewhere; a batch spec's tuple of data axes too."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import smoke_mesh
    from repro_torch.launch.multidevice_demo import init_world

    init_world(0, 1, "gloo")
    try:
        mesh = smoke_mesh(1, 1, "cpu")
        assert TP.placements((None, "model"), mesh) == [Replicate(), Shard(1)]
        assert TP.placements(("model", None, None), mesh) == [Replicate(), Shard(0)]
        assert TP.placements((("data",), None), mesh) == [Shard(0), Replicate()]
        assert TP.placements((None,), mesh) == [Replicate(), Replicate()]
        with pytest.raises(ValueError):
            TP.placements(("model", "model"), mesh)
    finally:
        dist.destroy_process_group()
    assert torch.distributed.is_initialized() is False
