"""The launch planning layer of the PyTorch port (`repro_torch.launch`:
`analytic`, `specs`, `step_analysis`, `dryrun`, and
`models.transformer.param_shapes`) against the JAX package's
`repro.launch` and `jax.eval_shape`, on the CPU.

Gates:
  * the analytic model (`param_counts`, `model_flops`, `analytic_cost`,
    the control plane's `projection_ops`, `polyblock_solve_cost`,
    `roofline_pct`): equal (==) to the JAX package's, the roofline with
    the JAX module's own TPU constants and 256 chips handed to the port's
    `HW`;
  * `param_shapes`, `input_specs`, `decode_input_specs`, `cache_specs`:
    every leaf's shape and dtype equal to the JAX ShapeDtypeStructs, no
    leaf with storage;
  * counted FLOPs of the smoke configs (`step_analysis.analyze_step` on
    meta tensors): the forward pass equals `model_flops`' forward plus
    the named gaps below exactly (relative 1e-12, float sums); a train
    step without remat three times its forward exactly; with remat (the
    dry run's step) between 3 and 4 forwards less the LM heads, which are
    not recomputed.  The gaps, each a term of the analytic model that the
    port's code computes otherwise:
      - full_scores: the plain attention computes every score and masks
        it, where the analytic model halves the causal window;
      - moe_capacity: every expert runs its whole capacity of slots
        (T * top_k at T * top_k <= 256, else 1.25 T * top_k / E + 1), where
        the analytic model runs T * top_k * 1.25;
      - rwkv_state: the WKV recurrence is elementwise, so it is not a
        counted matmul (the analytic model prices 4 b s d hs);
      - mamba: the scan's read-out einsum is a counted matmul (2 b s di N),
        its state update and the depthwise conv are elementwise (the
        analytic model prices 6 b s di N and the conv as a matmul);
  * `dryrun.main` in-process prints "1 passed, 0 failed";
  * `init_params` draws: bitwise the digests of the tree before
    `param_shapes` existed (one CPU generator, every smoke config, and
    one config drawn in slices of 64 elements).
"""
from _torch_oracle import enable_x64  # noqa: F401,I001  (alias first)

import dataclasses
import hashlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import analytic as JA
from repro.launch import specs as JS
from repro.models import transformer as JT
from repro_torch.configs import ARCHS, INPUT_SHAPES, InputShape, get_config
from repro_torch.launch import analytic as TA
from repro_torch.launch import dryrun
from repro_torch.launch import specs as TS
from repro_torch.launch.step_analysis import analyze_step, collective_stats, tree_nbytes
from repro_torch.models import layers
from repro_torch.models import transformer as TT
from repro_torch.models.moe import _capacity
from repro_torch.train.optimizer import sgd
from repro_torch.train.train_step import make_train_step
from repro_torch.train.tree import jax_leaves

ALL = list(ARCHS)
SHAPES = list(INPUT_SHAPES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The analytic model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL)
def test_param_counts_and_model_flops_equal_jax(arch):
    tcfg, jcfg = get_config(arch), jax_get_config(arch)
    assert TA.param_counts(tcfg) == JA.param_counts(jcfg)
    for name in SHAPES:
        assert TA.model_flops(tcfg, INPUT_SHAPES[name]) == JA.model_flops(jcfg, _jshape(name))


def _jshape(name):
    from repro.configs.base import INPUT_SHAPES as J_SHAPES
    return J_SHAPES[name]


@pytest.mark.parametrize("arch", ALL)
@pytest.mark.parametrize("shape", SHAPES)
def test_analytic_cost_equals_jax_on_jax_hardware(arch, shape):
    """The port's formulas on the JAX module's hardware (its PEAK_FLOPS,
    HBM_BW, LINK_BW and 256 chips), with a collective term."""
    tcfg = get_config(arch).for_shape(INPUT_SHAPES[shape])
    jcfg = jax_get_config(arch).for_shape(_jshape(shape))
    hw = TA.HW(peak_flops=JA.PEAK_FLOPS, hbm_bw=JA.HBM_BW, link_bw=JA.LINK_BW, chips=256)
    assert hw == TA.HW(**dataclasses.asdict(JA.HW()))
    for coll in (0.0, 3.5e9):
        assert TA.analytic_cost(tcfg, INPUT_SHAPES[shape], hw, coll) == \
            JA.analytic_cost(jcfg, _jshape(shape), JA.HW(), coll)


def test_h100_is_the_default_hardware():
    assert TA.HW() == TA.H100
    assert (TA.H100.peak_flops, TA.H100.hbm_bw, TA.H100.link_bw, TA.H100.chips) == \
        (989e12, 3.35e12, 450e9, 1)
    assert (TA.GPU_HW.flops_f64, TA.GPU_HW.flops_f32, TA.GPU_HW.mem_gbps * 1e9) == \
        (34e12, 67e12, 3.35e12)
    cfg, shape = get_config("qwen2-7b"), INPUT_SHAPES["train_4k"]
    roof = TA.analytic_cost(cfg, shape)
    assert roof["compute_s"] == TA.model_flops(cfg, shape)["train_total"] / 989e12


@pytest.mark.parametrize("kind", ["bisect", "newton", "mixed"])
def test_projection_ops_equal_jax(kind):
    for kw in ({}, {"n_bisect": 7, "n_f32": 3, "n_f64": 2}):
        t, j = TA.projection_ops(kind, **kw), JA.projection_ops(kind, **kw)
        assert t.to_dict() == j.to_dict() and t.weighted() == j.weighted()
    assert TA.g_eval_ops().to_dict() == JA.g_eval_ops().to_dict()
    assert TA._f_eval_ops().to_dict() == JA._f_eval_ops().to_dict()
    assert TA.OP_WEIGHTS == JA.OP_WEIGHTS
    with pytest.raises(ValueError):
        TA.projection_ops("halley")


def test_control_plane_helpers_price_the_reference_terms():
    """The helpers chip_smoke.py prices K1 and K2 with: one halving, the
    projection's fixed part and the selection's fixed part, in
    add-equivalents, as the JAX model spells them inline."""
    step = TA.bisect_step_ops().weighted()
    assert step == (JA.projection_ops("bisect", n_bisect=1).weighted()
                    - JA.projection_ops("bisect", n_bisect=0).weighted()) == 35.0
    assert TA.projection_ops("bisect", n_bisect=0).weighted() == 32.0
    sel = JA.polyblock_solve_cost(1000, solver="pallas", store_slots=0.0)["stage_compute"]
    flops_rate = JA.CPU_HW.flops_f64
    iters = 1000 * 0.45 * 1.6 * 2.9
    assert sel["select"] * flops_rate == pytest.approx(iters * TA.select_fixed_ops().weighted(),
                                                       rel=1e-12)


@pytest.mark.parametrize("solver", ["step", "fused", "pallas"])
@pytest.mark.parametrize("itemsize", [8, 4])
def test_polyblock_solve_cost_equals_jax(solver, itemsize):
    """Both packages on the same hardware fields: the CPU box, and the
    card's (the JAX function reads flops_f64, flops_f32 and mem_gbps)."""
    for thw, jhw in ((TA.CpuHW(), JA.CpuHW()), (TA.CpuHW(cores=8, ghz=2.5), JA.CpuHW(cores=8, ghz=2.5)),
                     (TA.GPU_HW, TA.GPU_HW)):
        for n in (1, 883, 116_865):
            kw = dict(solver=solver, itemsize=itemsize, mean_iters=3.7)
            got = TA.polyblock_solve_cost(n, hw=thw, **kw)
            want = JA.polyblock_solve_cost(n, hw=jhw, **kw)
            assert got == want
            assert TA.roofline_pct(1.5e-3, got) == JA.roofline_pct(1.5e-3, want)
    with pytest.raises(ValueError):
        TA.polyblock_solve_cost(10, solver="bisect")


# The JAX package's own launch tests (tests/test_sharding_and_launch.py),
# mirrored on the port's model and its meta-device tree.

def test_analytic_param_counts_match_meta_tree():
    for arch in ("qwen2-7b", "yi-6b", "rwkv6-7b", "granite-moe-3b-a800m",
                 "jamba-v0.1-52b", "deepseek-v3-671b", "qwen1.5-110b"):
        cfg = get_config(arch)
        real = TT.param_count(TT.param_shapes(cfg))
        pred = TA.param_counts(cfg)["total"]
        assert abs(pred - real) / real < 0.02, (arch, pred, real)


def test_analytic_flops_sane():
    cfg = get_config("qwen2-7b")
    shape = INPUT_SHAPES["train_4k"]
    mf = TA.model_flops(cfg, shape)
    assert 0.75 < mf["six_nd_active"] / mf["train_total"] < 1.25
    roof = TA.analytic_cost(cfg, shape, TA.HW(chips=256))
    assert roof["dominant"] == "compute_s"
    assert 0.8 < roof["useful_ratio"] < 1.25


def test_known_param_totals():
    expect = {"deepseek-v3-671b": 671e9, "qwen1.5-110b": 111e9, "qwen2-7b": 7.6e9,
              "yi-6b": 6.1e9, "jamba-v0.1-52b": 52e9, "rwkv6-7b": 7.0e9}
    for arch, n in expect.items():
        got = TA.param_counts(get_config(arch))["total"]
        assert abs(got - n) / n < 0.15, (arch, got / 1e9)


# ---------------------------------------------------------------------------
# Shapes: parameters, inputs, caches
# ---------------------------------------------------------------------------

_DT = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32,
       jnp.dtype(jnp.int32): torch.int32}


def _jax_tree(tree, prefix=()):
    """{path: (shape, torch dtype)} of a JAX ShapeDtypeStruct tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_jax_tree(v, prefix + (str(k),)))
        return out
    return {prefix: (tuple(tree.shape), _DT[jnp.dtype(tree.dtype)])}


def _port_tree(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_tree(v, prefix + (str(k),)))
        return out
    assert isinstance(tree, torch.Tensor) and tree.is_meta, (prefix, type(tree))
    assert tree.untyped_storage().data_ptr() == 0
    return {prefix: (tuple(tree.shape), tree.dtype)}


@pytest.mark.parametrize("arch", ALL)
def test_param_shapes_equal_jax_eval_shape(arch):
    """Leaf for leaf, the stacked JAX groups (`s{si}_l{li}`, `encoder`)
    unstacked along their leading repeats axis as in `params_from_jax`."""
    tcfg, jcfg = get_config(arch), jax_get_config(arch)
    shapes = jax.eval_shape(lambda k: JT.init_params(jcfg, k), jax.random.PRNGKey(0))
    t0 = time.perf_counter()
    tp = TT.param_shapes(tcfg)
    built_s = time.perf_counter() - t0
    assert built_s < 10.0, built_s
    groups = {f"s{si}_l{li}": st.repeats for si, st in enumerate(TT.stage_plan(tcfg))
              for li in range(len(st.pattern))}
    groups["encoder"] = tcfg.n_encoder_layers
    assert set(tp) == set(shapes)
    for name, sub in shapes.items():
        if name in groups:
            assert isinstance(tp[name], list) and len(tp[name]) == groups[name]
            want = {path: (shape[1:], dt) for path, (shape, dt) in _jax_tree(sub).items()}
            for i, layer in enumerate(tp[name]):
                assert _port_tree(layer) == want, (name, i)
            assert all(s[0] == groups[name] for s, _ in _jax_tree(sub).values())
        else:
            assert _port_tree(tp[name]) == _jax_tree(sub), name
    assert TT.param_count(tp) == sum(int(np.prod(a.shape))
                                     for a in jax.tree_util.tree_leaves(shapes))


@pytest.mark.parametrize("arch", ALL)
@pytest.mark.parametrize("shape", SHAPES)
def test_specs_equal_jax(arch, shape):
    tcfg = get_config(arch).for_shape(INPUT_SHAPES[shape])
    jcfg = jax_get_config(arch).for_shape(_jshape(shape))
    ts, js = INPUT_SHAPES[shape], _jshape(shape)
    assert _port_tree(TS.input_specs(tcfg, ts)) == _jax_tree(JS.input_specs(jcfg, js))
    assert _port_tree(TS.decode_input_specs(tcfg, ts)) == \
        _jax_tree(JS.decode_input_specs(jcfg, js))
    assert _port_tree(TS.cache_specs(tcfg, ts)) == _jax_tree(JS.cache_specs(jcfg, js))


def test_cache_specs_bytes_equal_a_real_prefill_cache():
    """On the CPU at smoke size, the meta cache of a (B, S) context has the
    summed nbytes of the cache a prefill with that many slots returns."""
    from repro_torch.train.serve_step import make_prefill_step
    for arch in ALL:
        cfg = get_config(arch + "-smoke")
        b, s, headroom = 2, 24, 8
        params = TT.init_params(cfg, torch.Generator().manual_seed(0))
        batch = {"tokens": torch.zeros(b, s, dtype=torch.int32)}
        if cfg.family == "audio":
            batch["enc_frames"] = torch.zeros(b, cfg.encoder_seq, cfg.d_model,
                                              dtype=torch.bfloat16)
        _, cache = make_prefill_step(cfg, cache_headroom=headroom)(params, batch)
        want = TS.cache_specs(cfg, InputShape("serve", s + headroom, b, "decode"))
        assert _port_tree(want) == {p: (tuple(t.shape), t.dtype)
                                    for p, t in _flat(cache).items()}, arch
        assert tree_nbytes(want) == tree_nbytes(cache)
        assert tree_nbytes(TT.param_shapes(cfg)) == tree_nbytes(params)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------------------
# Counted FLOPs against the analytic model
# ---------------------------------------------------------------------------

def flop_gaps(cfg, b: int, s: int) -> dict:
    """The terms by which the port's counted forward FLOPs differ from
    `model_flops`' forward at (b, s) (module docstring), by name."""
    t = b * s
    gaps: dict[str, float] = {}

    def add(name, v):
        gaps[name] = gaps.get(name, 0.0) + v

    for st in TT.stage_plan(cfg):
        for kind in st.pattern:
            r = st.repeats
            if kind.mixer in ("attn", "mla"):
                dh, dv = ((cfg.head_dim, cfg.head_dim) if kind.mixer == "attn" else
                          (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim))
                add("full_scores", r * 2.0 * b * cfg.n_heads * s * (s - s / 2.0) * (dh + dv))
            elif kind.mixer == "rwkv":
                add("rwkv_state", -r * 4.0 * b * s * cfg.d_model * cfg.rwkv_head_size)
            elif kind.mixer == "mamba":
                di, n = cfg.mamba_d_inner, cfg.mamba_d_state
                add("mamba", r * (2.0 * t * di * n - 6.0 * t * di * n
                                  - 2.0 * t * cfg.mamba_d_conv * di))
            if kind.ffn == "moe":
                per = 3 * cfg.d_model * cfg.ffn_expert
                _, active = TA._moe_params(cfg)
                counted = (2.0 * cfg.n_experts * _capacity(t, cfg) * per
                           + 2.0 * t * (cfg.n_shared_experts * per + cfg.d_model * cfg.n_experts))
                add("moe_capacity", r * (counted - 2.0 * t * active))
    return gaps


B, S = 2, 64
ARCH_GAPS = {  # the named gaps each smoke config shows, none other
    "qwen2-7b": {"full_scores"}, "stablelm-3b": {"full_scores"}, "yi-6b": {"full_scores"},
    "qwen1.5-110b": {"full_scores"}, "qwen2-vl-2b": {"full_scores"},
    "whisper-base": {"full_scores"}, "rwkv6-7b": {"rwkv_state"},
    "granite-moe-3b-a800m": {"full_scores", "moe_capacity"},
    "deepseek-v3-671b": {"full_scores", "moe_capacity"},
    "jamba-v0.1-52b": {"full_scores", "moe_capacity", "mamba"},
}


@pytest.mark.parametrize("arch", ALL)
def test_counted_flops_against_model_flops(arch):
    cfg = get_config(arch + "-smoke")
    params = TT.param_shapes(cfg)
    prefill_shape = InputShape("p", S, B, "prefill")
    train_shape = InputShape("t", S, B, "train")
    gaps = flop_gaps(cfg, B, S)
    assert set(gaps) == ARCH_GAPS[arch]

    fn, args = dryrun.build_step(cfg, prefill_shape)
    prefill = analyze_step(fn, *args)["flops"]
    want = TA.model_flops(cfg, prefill_shape)["forward"] + sum(gaps.values())
    assert prefill == pytest.approx(want, rel=1e-12), gaps

    batch = TS.input_specs(cfg, train_shape)
    fwd = analyze_step(lambda p, bt: TT.forward(cfg, p, bt, mode="train"), params, batch)
    want = TA.model_flops(cfg, train_shape)["forward"] + sum(gaps.values())
    assert fwd["flops"] == pytest.approx(want, rel=1e-12)
    plain = analyze_step(make_train_step(cfg, sgd(0.1), remat=False), params, (), batch)
    assert plain["flops"] == 3 * fwd["flops"]
    remat = analyze_step(make_train_step(cfg, sgd(0.1), remat=True), params, (), batch)
    heads = 2.0 * B * S * cfg.vocab * cfg.d_model * (2 if cfg.mtp else 1)
    assert 3 * fwd["flops"] < remat["flops"] <= 4 * fwd["flops"] - heads
    # The dry run's own count (depth-scaled for rwkv and jamba) is the same.
    assert dryrun.analyze(cfg, train_shape)["flops"] == remat["flops"]


def test_depth_scaled_matches_the_full_run():
    """`depth_scaled` (1 and 2 repeats, scaled) against the step run at
    full depth: FLOPs, output and temp bytes equal."""
    from repro_torch.launch.step_analysis import depth_scaled
    for arch, kind, n_layers in (("rwkv6-7b", "prefill", 5), ("rwkv6-7b", "train", 4),
                                 ("jamba-v0.1-52b", "prefill", 24),
                                 ("jamba-v0.1-52b", "train", 24)):
        cfg = dataclasses.replace(get_config(arch + "-smoke"), n_layers=n_layers)
        shape = InputShape(kind, 16, 2, kind)

        def run(c):
            fn, args = dryrun.build_step(c, shape)
            return analyze_step(fn, *args)

        full, scaled = run(cfg), depth_scaled(cfg, run)
        assert scaled.pop("depth_scaled") == n_layers // len(TT.stage_plan(cfg)[0].pattern)
        assert scaled == full, (arch, kind)


def test_live_bytes_tracks_frees():
    from repro_torch.launch.step_analysis import LiveBytes
    x = torch.empty(1024, device="meta")
    with LiveBytes(known=(x,)) as live:
        a = x * 2                      # 4 KiB
        b = a.view(32, 32)             # a view: nothing new
        del a
        c = b + 1                      # 4 KiB more, 8 live
        del b, c
        d = torch.empty(512, device="meta")   # 2 KiB, after both were freed
    assert live.peak == 8192 and live.current == 2048 and d.numel() == 512


def test_collective_stats_on_one_card():
    out = collective_stats()
    assert set(out) == set(TA_COLL) and not any(out.values())


TA_COLL = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute",
           "total", "raw_total", "count")


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [("whisper-base", "decode_32k"),
                                        ("qwen2-7b", "train_4k")])
def test_dryrun_main_in_process(arch, shape, tmp_path, capsys):
    import json
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", arch, "--shape", shape, "--json", str(out),
                        "--one-card"]) == 0
    assert "1 passed, 0 failed" in capsys.readouterr().out
    res = json.loads(out.read_text())["results"][0]
    cfg = get_config(arch)
    assert (res["devices"], res["mesh"]) == (1, "1")
    assert res["collectives"]["total"] == 0
    assert res["roofline"] == json.loads(json.dumps(
        TA.analytic_cost(cfg, INPUT_SHAPES[shape], TA.H100)))
    fn, args = dryrun.build_step(cfg, INPUT_SHAPES[shape])
    assert res["argument_size_in_bytes"] == tree_nbytes(args)
    assert res["temp_size_in_bytes"] > 0 and res["counted_flops"] > 0
    if shape == "train_4k":
        # AdamW's two f32 moments beside bf16 parameters: 5x the bf16 bytes.
        params = tree_nbytes(TT.param_shapes(cfg))
        batch = tree_nbytes(TS.input_specs(cfg, INPUT_SHAPES[shape]))
        assert res["argument_size_in_bytes"] == pytest.approx(5 * params + batch, rel=1e-4)


def test_dryrun_override_and_refused_flags(capsys):
    assert dryrun.main(["--arch", "jamba-v0.1-52b", "--shape", "decode_32k", "--one-card",
                        "--override", "n_layers=8", "--override", "mla_absorb=True"]) == 0
    assert "1 passed, 0 failed" in capsys.readouterr().out
    # The production mesh's flags take no one-card run.
    for flag in ("--multi-pod", "--detail", "--attn-shard=explicit"):
        with pytest.raises(SystemExit):
            dryrun.main(["--arch", "qwen2-7b", "--shape", "train_4k", "--one-card", flag])


def test_adafactor_state_on_meta_matches_jax():
    """deepseek-v3's and jamba's dry-run optimizer: the factored moments of
    a stacked per-layer group, as jax.eval_shape(opt.init) has them."""
    from repro.train.optimizer import make_optimizer as jax_make_optimizer
    from repro_torch.train.optimizer import make_optimizer
    for arch in ("deepseek-v3-671b", "jamba-v0.1-52b"):
        tcfg, jcfg = get_config(arch), jax_get_config(arch)
        assert tcfg.optimizer == "adafactor"
        jshapes = jax.eval_shape(lambda k: JT.init_params(jcfg, k), jax.random.PRNGKey(0))
        jstate = jax.eval_shape(jax_make_optimizer("adafactor", 1e-4).init, jshapes)
        tstate = make_optimizer("adafactor", 1e-4).init(TT.param_shapes(tcfg))
        jl = jax.tree_util.tree_leaves_with_path(jstate)
        tl = jax_leaves(tstate)
        assert [tuple(a.shape) for _, a in jl] == [tuple(t.shape) for _, t in tl]


# ---------------------------------------------------------------------------
# init_params' draws
# ---------------------------------------------------------------------------

DRAW_DIGESTS = {   # sha256[:16] of init_params(cfg-smoke, CPU generator seed 0)
    "qwen2-7b": "8750e1371cc8d454", "rwkv6-7b": "38b1d0b91adbfb25",
    "stablelm-3b": "22e7518d8d481f60", "yi-6b": "22e7518d8d481f60",
    "qwen1.5-110b": "8750e1371cc8d454", "granite-moe-3b-a800m": "74ff0946bd9908f5",
    "deepseek-v3-671b": "d821fe6f826e42e5", "jamba-v0.1-52b": "d7641a36dc032eb4",
    "whisper-base": "39a19cdc875a5c4b", "qwen2-vl-2b": "8750e1371cc8d454",
}
SLICED_DIGEST = "ef7b9a03ba844fd1"   # qwen2-7b-smoke, seed 1, DRAW_SLICE_ELEMS = 64


def _digest(tree) -> str:
    h = hashlib.sha256()
    for path, leaf in jax_leaves(tree):
        for t in (leaf if isinstance(leaf, list) else [leaf]):
            h.update("/".join(path).encode())
            h.update(str(t.dtype).encode())
            h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("arch", ALL)
def test_init_params_draws_unchanged(arch):
    tree = TT.init_params(get_config(arch + "-smoke"), torch.Generator().manual_seed(0))
    assert _digest(tree) == DRAW_DIGESTS[arch]


def test_init_params_sliced_draws_unchanged(monkeypatch):
    monkeypatch.setattr(layers, "DRAW_SLICE_ELEMS", 64)
    tree = TT.init_params(get_config("qwen2-7b-smoke"), torch.Generator().manual_seed(1))
    assert _digest(tree) == SLICED_DIGEST


def test_wkv6_meta_gives_the_kernel_outputs_without_a_launch():
    """K5's wrapper on meta tensors (the dry run of the kernel path): the
    kernel's output shapes and dtypes, nothing launched, no Python loop; a
    dry run of rwkv6-7b's kernel path counts what its "ref" path counts."""
    from repro_torch.kernels.rwkv6_wkv import wkv6
    b, t, h, hs = 2, 4096, 64, 64
    r = torch.empty(b, t, h, hs, device="meta")
    state = torch.empty(b, h, hs, hs, device="meta")
    before = wkv6.launches
    y, s = wkv6(r, r, r, r, torch.empty(h, hs, device="meta"), state)
    assert (y.shape, y.dtype, y.is_meta) == (r.shape, torch.float32, True)
    assert (s.shape, s.dtype, s.is_meta) == (state.shape, torch.float32, True)
    assert wkv6.launches == before
    cfg = get_config("rwkv6-7b-smoke")
    shape = InputShape("p", 32, 2, "prefill")
    kernel_path = dryrun.analyze(dataclasses.replace(cfg, rwkv_wkv_impl="pallas"), shape)
    ref_path = dryrun.analyze(cfg, shape)
    assert kernel_path["depth_scaled"] == 0 and ref_path["depth_scaled"] == 0
    assert kernel_path["flops"] == ref_path["flops"]
    assert kernel_path["output_size_in_bytes"] == ref_path["output_size_in_bytes"]
