"""The audio and VLM families' modules in the PyTorch port against the JAX
package, on the CPU, on the JAX package's own weights (`params_from_jax`):
M-RoPE (`apply_mrope`, `_mrope_sections`, `_project_qkv`, `gqa_forward`
and `gqa_decode` with `mrope_pos`, qwen2-vl-2b-smoke), non-causal
attention, `cross_attn` and the audio encoder (`_encode_audio`,
whisper-base-smoke), the patch splice (`_embed`), the stage plan, the
parameter tree with the encoder unstacked, and the encoder output in the
decode cache.

M-RoPE equals RoPE when its three position streams are equal, and the
JAX package's serve_loop and train_loop feed arange on all three, so these tests feed a
real 3-D grid (`layers.mrope_grid`: Qwen2-VL's `get_rope_index` layout, a
4 x 4 patch grid at the smoke configs' n_patches 16) and assert that it
moves the rotation off RoPE's.

Tolerances (of the scale, max |diff| / max |want|): f32 M-RoPE 1e-5 (the
same f32 products, cos and sin of two libraries: measured 6.1e-8 on an
x86-64 CPU); every bf16 output 4e-2, the JAX package's serving tolerance
(tests/test_serving.py; measured 0 for M-RoPE, the splice, the decode step
and cross-attention, 9.7e-4 to 1.1e-3 for the attention layers, 9.5e-3 for the
two-layer encoder: bf16 GEMMs summed in other orders).
"""
from _torch_oracle import jax_llm_params, rel_max  # noqa: I001  (alias first)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.moe import ShardCtx
from repro_torch.configs import get_config
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

TOL, F32_TOL = 4e-2, 1e-5
WHISPER, QWEN_VL = "whisper-base-smoke", "qwen2-vl-2b-smoke"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(arch, **kw):
    return (dataclasses.replace(jax_get_config(arch), **kw),
            dataclasses.replace(get_config(arch), **kw))


def _params(jcfg, tcfg, seed=3):
    jp_np = jax_llm_params(jcfg, seed)
    return jax.tree_util.tree_map(jnp.asarray, jp_np), TT.params_from_jax(tcfg, jp_np)


def _layer0(jcfg, tcfg, group="s0_l0"):
    jp, tp = _params(jcfg, tcfg)
    return jax.tree_util.tree_map(lambda a: a[0], jp[group]), tp[group][0]


def _x(shape, seed, dtype=jnp.bfloat16, scale=1.0):
    x = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdtype)


def _grid(b, s, n_patches):
    g = TL.mrope_grid(b, s, n_patches)
    return jnp.asarray(g.numpy()), g


# --------------------------------------------------------------------------
# M-RoPE
# --------------------------------------------------------------------------

def test_mrope_sections_match_jax():
    for dh, want in ((128, (16, 24, 24)), (64, (8, 12, 12)), (80, (10, 15, 15))):
        assert TA._mrope_sections(dh) == JA._mrope_sections(dh) == want


def test_mrope_grid_is_the_get_rope_index_layout():
    """Patch (r, c) of the 4 x 4 grid at (0, r, c); text token i at 4 + i
    on all three streams; non-square patch counts and prompts shorter than
    the image raise."""
    g = TL.mrope_grid(2, 20, 16)
    assert g.shape == (2, 20, 3) and g.dtype == torch.int32
    r, c = np.divmod(np.arange(16), 4)
    assert np.array_equal(g[0, :16].numpy(), np.stack([np.zeros(16), r, c], -1))
    assert np.array_equal(g[1, 16:].numpy(), np.repeat(np.arange(4, 8)[:, None], 3, 1))
    for bad in ((2, 20, 15), (2, 12, 16)):
        with pytest.raises(ValueError, match="mrope_grid"):
            TL.mrope_grid(*bad)


@pytest.mark.parametrize("dh", [128, 64])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_mrope_matches_jax_on_a_3d_grid(dh, dtype):
    """At head dims 128 (qwen2-vl-2b) and 64 (the smoke configs), with the
    sections `_mrope_sections` gives; the grid rotates differently from
    RoPE at arange (in both packages), and equal streams give RoPE's
    rotation exactly."""
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    b, s, h, theta = 2, 24, 3, 1e6
    xj, xt = _x((b, s, h, dh), 1, jdt)
    gj, gt = _grid(b, s, 16)
    sections = TA._mrope_sections(dh)
    want = JL.apply_mrope(xj, gj, theta, sections)
    got = TL.apply_mrope(xt, gt, theta, sections)
    assert got.dtype == xt.dtype and tuple(got.shape) == want.shape
    assert rel_max(got, want) < (F32_TOL if dtype == "f32" else TOL)
    arange = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    rope = TL.apply_rope(xt, arange, theta)
    assert rel_max(got, rope) > 0.1
    assert rel_max(want, JL.apply_rope(xj, jnp.asarray(arange.numpy()), theta)) > 0.1
    equal = TL.apply_mrope(xt, arange[..., None].expand(b, s, 3), theta, sections)
    assert torch.equal(equal, rope)


def test_apply_mrope_refuses_sections_off_the_head_dim():
    with pytest.raises(ValueError, match="sections"):
        TL.apply_mrope(torch.zeros(1, 2, 1, 64), torch.zeros(1, 2, 3, dtype=torch.int32), 1e4,
                       (16, 24, 24))


def test_project_qkv_with_mrope_matches_jax():
    jcfg, tcfg = _configs(QWEN_VL)
    jp, tp = _layer0(jcfg, tcfg)
    b, s = 2, 24
    xj, xt = _x((b, s, jcfg.d_model), 2)
    gj, gt = _grid(b, s, jcfg.n_patches)
    pos = jnp.arange(s, dtype=jnp.int32)[None]
    want = JA._project_qkv(jp["attn"], jcfg, xj, pos, gj)
    got = TA._project_qkv(tp["attn"], tcfg, xt, torch.arange(s, dtype=torch.int32)[None], gt)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and rel_max(g, w) < TOL
    rope = TA._project_qkv(tp["attn"], tcfg, xt, torch.arange(s, dtype=torch.int32)[None])
    assert rel_max(got[0], rope[0]) > 0.1 and torch.equal(got[2], rope[2])


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_gqa_forward_with_mrope_matches_jax(impl):
    """Causal prefill attention with M-RoPE on the grid: output and the
    rotated (k, v), the JAX K4 in interpret mode against the port's plain
    K4 version for "pallas"."""
    jcfg, tcfg = _configs(QWEN_VL, attn_impl=impl)
    jp, tp = _layer0(jcfg, tcfg)
    b, s = 2, 32
    xj, xt = _x((b, s, jcfg.d_model), 3)
    gj, gt = _grid(b, s, jcfg.n_patches)
    want, (kj, vj) = JA.gqa_forward(jp["attn"], jcfg, xj, mrope_pos=gj, return_kv=True)
    got, (kt, vt) = TA.gqa_forward(tp["attn"], tcfg, xt, mrope_pos=gt, return_kv=True)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    for g, w in ((got, want), (kt, kj), (vt, vj)):
        assert rel_max(g, w) < TOL


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_gqa_forward_non_causal_matches_jax_and_never_reaches_k4(impl, monkeypatch):
    """causal=False (the audio encoder): no mask, the plain `_sdpa` whatever
    attn_impl says, as the JAX package never sends it to its flash
    kernel; it differs from the causal output."""
    jcfg, tcfg = _configs(WHISPER, attn_impl=impl)
    jp, tp = _layer0(jcfg, tcfg, "encoder")
    xj, xt = _x((2, 40, jcfg.d_model), 4)
    want = JA.gqa_forward(jp["attn"], jcfg, xj, causal=False)

    def refuse(*a, **kw):
        raise AssertionError("non-causal attention reached K4")

    monkeypatch.setattr(TA, "flash_attention", refuse)
    got = TA.gqa_forward(tp["attn"], tcfg, xt, causal=False)
    assert rel_max(got, want) < TOL
    causal = TA.gqa_forward(tp["attn"], dataclasses.replace(tcfg, attn_impl="ref"), xt)
    assert rel_max(got, causal) > 0.1


def test_gqa_decode_with_mrope_matches_jax():
    """One decode step over a part-filled ring at a random (B, 1, 3) M-RoPE
    position: output, ring write, positions and idx."""
    jcfg, tcfg = _configs(QWEN_VL)
    jp, tp = _layer0(jcfg, tcfg)
    b, c, s = 2, 20, 13
    kj, kt = _x((b, c, jcfg.n_kv_heads, jcfg.head_dim), 5)
    vj, vt = _x((b, c, jcfg.n_kv_heads, jcfg.head_dim), 6)
    pos = np.where(np.arange(c) < s, np.arange(c), -1).astype(np.int32)
    jcache = {"k": kj, "v": vj, "pos": jnp.asarray(pos), "idx": jnp.asarray(s, jnp.int32)}
    tcache = {"k": kt, "v": vt, "pos": torch.from_numpy(pos.copy()),
              "idx": torch.tensor(s, dtype=torch.int32)}
    mrope = np.random.default_rng(7).integers(0, 40, (b, 1, 3)).astype(np.int32)
    xj, xt = _x((b, 1, jcfg.d_model), 8)
    want, jnew = JA.gqa_decode(jp["attn"], jcfg, xj, jcache, jnp.asarray(s, jnp.int32),
                               mrope_pos=jnp.asarray(mrope))
    got, tnew = TA.gqa_decode(tp["attn"], tcfg, xt, tcache, torch.tensor(s, dtype=torch.int32),
                              mrope_pos=torch.from_numpy(mrope))
    assert tnew is tcache and rel_max(got, want) < TOL
    assert np.array_equal(tnew["pos"].numpy(), np.asarray(jnew["pos"]))
    assert int(tnew["idx"]) == s + 1
    for name in ("k", "v"):
        assert rel_max(tnew[name], jnew[name]) < TOL


# --------------------------------------------------------------------------
# Cross-attention, the encoder, the patch splice
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sq", [1, 12])
def test_cross_attn_matches_jax(sq):
    """Decode (Sq 1) and prefill queries against 64 encoder frames."""
    jcfg, tcfg = _configs(WHISPER)
    jp, tp = _layer0(jcfg, tcfg)
    assert set(tp) == {"ln1", "attn", "ln_c", "cross", "ln2", "ffn"}
    xj, xt = _x((2, sq, jcfg.d_model), 9)
    ej, et = _x((2, jcfg.encoder_seq, jcfg.d_model), 10)
    want = JA.cross_attn(jp["cross"], jcfg, xj, ej)
    got = TA.cross_attn(tp["cross"], tcfg, xt, et)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert rel_max(got, want) < TOL


def test_encode_audio_matches_jax_and_remat_is_bitwise():
    """The whole encoder (2 layers, non-causal, RoPE at arange(64), then
    enc_final_ln) on random frames; its checkpointed form computes the same
    bits."""
    jcfg, tcfg = _configs(WHISPER)
    jp, tp = _params(jcfg, tcfg)
    fj, ft = _x((2, jcfg.encoder_seq, jcfg.d_model), 11)
    want = JT._encode_audio(jcfg, jp, fj, ShardCtx())
    got = TT._encode_audio(tcfg, tp, ft)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert rel_max(got, want) < TOL
    assert torch.equal(TT._encode_audio(tcfg, tp, ft, remat=True), got)


def test_embed_splices_the_patches_as_jax():
    """image_embeds over the first n_patches positions, bitwise the JAX
    package's; tokens alone embed as the other archs; a sequence shorter
    than the image raises."""
    jcfg, tcfg = _configs(QWEN_VL)
    jp, tp = _params(jcfg, tcfg)
    toks = np.random.default_rng(12).integers(0, jcfg.vocab, (2, 20)).astype(np.int32)
    ij, it = _x((2, jcfg.n_patches, jcfg.d_model), 13, scale=0.02)
    want = JT._embed(jcfg, jp, {"tokens": jnp.asarray(toks), "image_embeds": ij}, ShardCtx())
    got = TT._embed(tcfg, tp, {"tokens": torch.from_numpy(toks), "image_embeds": it})
    assert rel_max(got, want) == 0.0
    assert torch.equal(got[:, :jcfg.n_patches], it)
    plain = TT._embed(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(plain[:, jcfg.n_patches:], got[:, jcfg.n_patches:])
    with pytest.raises(ValueError, match="n_patches"):
        TT._embed(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :8]), "image_embeds": it})


# --------------------------------------------------------------------------
# Plan, parameters, caches
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["whisper-base", "qwen2-vl-2b", WHISPER, QWEN_VL])
def test_stage_plan_matches_jax(arch):
    jcfg, tcfg = _configs(arch)
    plan = [([k.tag for k in st.pattern], st.repeats) for st in TT.stage_plan(tcfg)]
    assert plan == [([k.tag for k in st.pattern], st.repeats) for st in JT.stage_plan(jcfg)]
    tag = "attn-dense-x" if tcfg.is_encoder_decoder else "attn-dense"
    assert plan == [([tag], tcfg.n_layers)]


@pytest.mark.parametrize("arch", [WHISPER, QWEN_VL])
def test_params_from_jax_and_init_params_match_the_jax_tree(arch):
    """`params_from_jax` unstacks each layer group and the encoder along
    their leading axis, bitwise; `init_params` draws a tree of the same
    structure, shapes and dtypes, with the JAX package's constants (norm
    gains 1, QKV biases 0)."""
    jcfg, tcfg = _configs(arch)
    jp = jax_llm_params(jcfg, seed=1)
    tp = TT.params_from_jax(tcfg, jp)
    mine = TT.init_params(tcfg, torch.Generator().manual_seed(0))
    assert set(tp) == set(mine) == set(jp)
    assert ("encoder" in tp) == ("enc_final_ln" in tp) == tcfg.is_encoder_decoder
    assert TT.param_count(tp) == TT.param_count(mine) == JT.param_count(jp)
    groups = {"s0_l0": tcfg.n_layers, "encoder": tcfg.n_encoder_layers}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [p.key for p in path]
        reps = groups.get(keys[0])
        for i in range(reps or 1):
            node_t, node_m = tp[keys[0]], mine[keys[0]]
            if reps:
                node_t, node_m = node_t[i], node_m[i]
            for key in keys[1:]:
                node_t, node_m = node_t[key], node_m[key]
            want = np.asarray(leaf)[i] if reps else np.asarray(leaf)
            assert tuple(node_t.shape) == tuple(node_m.shape) == want.shape, keys
            assert str(node_t.dtype).split(".")[-1] == str(node_m.dtype).split(".")[-1] \
                == want.dtype.name, keys
            assert np.array_equal(node_t.float().numpy(), want.astype(np.float32)), keys
            if keys[-1] in ("g", "b"):
                assert np.array_equal(node_m.float().numpy(), want.astype(np.float32)), keys


def test_init_cache_holds_the_encoder_output():
    """An encoder-decoder's empty cache carries enc_out (and needs it); a
    cold decode from it cross-attends and leaves it as it was."""
    _, tcfg = _configs(WHISPER)
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="enc_out"):
        TT.init_cache(tcfg, 2, 16, "cpu")
    enc = torch.randn(2, tcfg.encoder_seq, tcfg.d_model).bfloat16()
    cache = TT.init_cache(tcfg, 2, 16, "cpu", enc_out=enc)
    assert cache["enc_out"] is enc
    keep = enc.clone()
    logits, cache = TT.decode_step(tcfg, tp, {"token": torch.zeros(2, 1, dtype=torch.int32),
                                              "pos": torch.tensor(0)}, cache)
    assert logits.shape == (2, 1, tcfg.vocab) and bool(torch.isfinite(logits.float()).all())
    assert torch.equal(cache["enc_out"], keep)
    assert cache["s0_l0"]["idx"].tolist() == [1] * tcfg.n_layers
