"""The audio and VLM families served and trained in the PyTorch port against
the JAX package, on the CPU, on the JAX package's own `init_params` draws
(`params_from_jax`): whisper-base-smoke (2 encoder + 2 decoder layers,
each decoder layer with a cross-attention to 64 encoder frames) and
qwen2-vl-2b-smoke (M-RoPE, 16 patch embeddings spliced over the first 16
positions), each with attn_impl "ref" and "pallas" on both sides (the JAX
K4 in interpret mode, the port's K4 plain version): prefill logits and
every cache leaf (the encoder output `enc_out` included), four
teacher-forced decode steps, the port's prefill + decode against its own
full forward, `serve_loop` and the CLI, `lm_loss` and its gradients
(encoder leaves included), `train_loop(fl=True)` against the JAX
package's, checkpoints across packages, and `examples/torch_serve_model.py`
on every arch's smoke config.

The VLM cases feed seeded random patch embeddings (scale 0.02) and a real
3-D M-RoPE grid (`layers.mrope_grid`), decode continuing it (g + p -
n_patches on all three streams at position p); the JAX serve_loop's zeros and
arange would make M-RoPE RoPE.  The audio cases feed seeded random frames.

Tolerances: serving 4e-2 of the scale (max |diff| / max |want|), the JAX
package's serving tolerance (tests/test_serving.py); ring positions and
write indices exact.  Measured on an x86-64 CPU, one thread, on these bf16
draws as they are: prefill logits 9.9e-3 to 1.4e-2 and cache leaves
(enc_out 1.1e-2) 5.7e-3 to 1.2e-2; four decode steps and the caches after
them up to 1.7e-2; the port's prefill + decode against its own full
forward 0 (bitwise).  F.silu's single rounding against XLA's op-by-op
bf16 SiLU (ROADMAP Queue 3) does not compound past 4e-2 through the
encoder and the decoder here, so every case runs on the draws as they are,
with F.silu, no f32 copies and no XLA-rounded SiLU.  Training at
tests/test_torch_train.py's gates: loss 5e-3 absolute (whisper 2.9e-5,
qwen2-vl 1.5e-4), global grad norm 2e-2 relative (1.1e-4, 2.3e-5), each
leaf's relative Frobenius error 5e-2 (2.0e-2, 2.7e-2).

At qwen2-vl-2b's full depth (28 layers, here at smoke width) the JAX
package's stub of zero patch embeddings makes the gradient non-finite in
both packages: each patch row's residual stays exactly 0 (the Q/K/V biases
start at 0), and every RMS norm's backward scales that row's gradient by
1/sqrt(eps).  On seeded patch embeddings of scale 0.02 both are finite
and the port's global grad norm sits within the training gate of JAX's
(loss gap 1.6e-4, grad norm 9.4e-4); `train_loop(frontend=)` trains on
such inputs.
"""
from _torch_oracle import f32, jax_llm_params, rel_max  # noqa: I001  (alias first)

import dataclasses
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore_checkpoint
from repro.configs import get_config as jax_get_config
from repro.launch import train as JL
from repro.launch.serve import serve_loop as jax_serve_loop
from repro.models import transformer as JT
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as TL
from repro_torch.models import layers as TLY
from repro_torch.models import transformer as TT
from repro_torch.train.tree import jax_leaves, tree_leaves, tree_unflatten

TOL = 4e-2
LOSS_ATOL, GNORM_RTOL, LEAF_RTOL = 5e-3, 2e-2, 5e-2
WHISPER, QWEN_VL = "whisper-base-smoke", "qwen2-vl-2b-smoke"
ARCH_PAIR = [WHISPER, QWEN_VL]
# case -> (arch, overrides on both sides)
CASES = {"whisper": (WHISPER, {}), "whisper-pallas": (WHISPER, {"attn_impl": "pallas"}),
         "qwen2-vl": (QWEN_VL, {}), "qwen2-vl-pallas": (QWEN_VL, {"attn_impl": "pallas"})}
EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "torch_serve_model.py"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(case, seed=11):
    arch, kw = CASES[case]
    jcfg = dataclasses.replace(jax_get_config(arch), **kw)
    tcfg = dataclasses.replace(get_config(arch), **kw)
    jp_np = jax_llm_params(jcfg, seed)
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, jp_np), TT.params_from_jax(tcfg, jp_np)


def _inputs(cfg, b, s, seed=0):
    """(jax batch, port batch): tokens and the family's frontend inputs,
    from one numpy generator; bf16 draws are handed over bit for bit."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}

    def bf16(name, shape, scale):
        x = jnp.asarray(scale * rng.standard_normal(shape), jnp.bfloat16)
        jb[name] = x
        tb[name] = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()

    if cfg.family == "audio":
        bf16("enc_frames", (b, cfg.encoder_seq, cfg.d_model), 1.0)
    if cfg.family == "vlm":
        bf16("image_embeds", (b, cfg.n_patches, cfg.d_model), 0.02)
        grid = TLY.mrope_grid(b, s, cfg.n_patches)
        jb["mrope_pos"], tb["mrope_pos"] = jnp.asarray(grid.numpy()), grid
    return jb, tb


def _decode_batch(cfg, tok: np.ndarray, pos: int):
    """(jax, port) decode batches at global position `pos`; the VLM's
    M-RoPE position continues `mrope_grid`'s text stream."""
    jb = {"token": jnp.asarray(tok), "pos": jnp.asarray(pos, jnp.int32)}
    tb = {"token": torch.from_numpy(tok), "pos": torch.tensor(pos, dtype=torch.int32)}
    if cfg.family == "vlm":
        m = np.full((tok.shape[0], 1, 3), math.isqrt(cfg.n_patches) + pos - cfg.n_patches,
                    np.int32)
        jb["mrope_pos"], tb["mrope_pos"] = jnp.asarray(m), torch.from_numpy(m)
    return jb, tb


def _port_leaf(cache, path):
    for p in path:
        cache = cache[p.key]
    return cache


def _check_cache(tcache, jcache):
    leaves = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert len(leaves) == len(jax.tree_util.tree_leaves(tcache))
    for path, want in leaves:
        got = _port_leaf(tcache, path)
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).split(".")[-1] == want.dtype.name, path
        if want.dtype == jnp.int32:                     # ring positions, write index
            assert np.array_equal(got.numpy(), np.asarray(want)), path
        else:
            assert rel_max(got, want) < TOL, path


# --------------------------------------------------------------------------
# Serving against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_logits_and_cache_match_jax(case):
    jcfg, tcfg, jp, tp = _setup(case)
    b, s, nd = 2, 32, 3
    jb, tb = _inputs(jcfg, b, s)
    jl, _, jcache = JT.forward(jcfg, jp, jb, mode="prefill", cache_headroom=nd)
    tl, _, tcache = TT.forward(tcfg, tp, tb, mode="prefill", cache_headroom=nd)
    assert tl.dtype == torch.bfloat16 and tuple(tl.shape) == jl.shape
    assert rel_max(tl, jl) < TOL
    assert ("enc_out" in tcache) == tcfg.is_encoder_decoder
    _check_cache(tcache, jcache)


@pytest.mark.parametrize("case", sorted(CASES))
def test_teacher_forced_decode_matches_jax(case):
    """Both decode the same tokens (JAX's greedy choices) from their own
    prefill caches: logits of every step within 4e-2, then every cache
    leaf; decode leaves the encoder output as prefill made it."""
    jcfg, tcfg, jp, tp = _setup(case)
    b, s, nd = 2, 24, 4
    jb, tb = _inputs(jcfg, b, s, seed=1)
    jl, _, jcache = JT.forward(jcfg, jp, jb, mode="prefill", cache_headroom=nd)
    _, _, tcache = TT.forward(tcfg, tp, tb, mode="prefill", cache_headroom=nd)
    enc = tcache["enc_out"].clone() if tcfg.is_encoder_decoder else None
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    for d in range(nd):
        jdb, tdb = _decode_batch(jcfg, tok, s + d)
        jg, jcache = JT.decode_step(jcfg, jp, jdb, jcache)
        tg, tcache = TT.decode_step(tcfg, tp, tdb, tcache)
        assert rel_max(tg, jg) < TOL, d
        tok = np.asarray(jnp.argmax(jg[:, -1], -1)).astype(np.int32)[:, None]
    _check_cache(tcache, jcache)
    if enc is not None:
        assert torch.equal(tcache["enc_out"], enc)


@pytest.mark.parametrize("arch", ARCH_PAIR)
def test_prefill_decode_matches_full(arch):
    """The port's prefill + ring-buffer decode of the true next tokens
    equals its own full forward over the whole sequence (frontend inputs
    and M-RoPE grid included)."""
    case = "whisper" if arch == WHISPER else "qwen2-vl"
    _, tcfg, _, tp = _setup(case)
    b, s, nd = 2, 24, 4
    _, tb = _inputs(tcfg, b, s + nd, seed=2)
    ref = TT.forward(tcfg, tp, tb)[0]
    pre = {k: (v[:, :s] if k in ("tokens", "mrope_pos") else v) for k, v in tb.items()}
    _, _, cache = TT.forward(tcfg, tp, pre, mode="prefill", cache_headroom=nd)
    for d in range(nd):
        step = {"token": tb["tokens"][:, s + d:s + d + 1],
                "pos": torch.tensor(s + d, dtype=torch.int32)}
        if "mrope_pos" in tb:
            step["mrope_pos"] = tb["mrope_pos"][:, s + d:s + d + 1]
        got, cache = TT.decode_step(tcfg, tp, step, cache)
        assert rel_max(got[:, 0], ref[:, s + d]) < TOL, d


@pytest.mark.parametrize("arch,impl", [(a, i) for a in ARCH_PAIR for i in ("ref", "pallas")])
def test_serve_loop_matches_jax_serve_loop(arch, impl):
    """Greedy tokens equal to the JAX package's serve_loop (its "ref"
    paths, its stub frontends) on the same weights, up to the first step
    where JAX's top-2 logit margin is under 2 x 4e-2 x max |logit|; from
    there the generations may part."""
    batch, prompt_len, new_tokens, seed = 2, 20, 5, 5
    want = jax_serve_loop(arch, batch=batch, prompt_len=prompt_len, new_tokens=new_tokens,
                          seed=seed)
    jcfg = jax_get_config(arch)
    cfg = dataclasses.replace(get_config(arch), attn_impl=impl)
    jp = jax_llm_params(jcfg, seed)
    got = serve_mod.serve_loop(cfg, batch=batch, prompt_len=prompt_len, new_tokens=new_tokens,
                               seed=seed, device="cpu", params=TT.params_from_jax(cfg, jp))
    assert got.tokens.shape == want.shape and got.tokens.dtype == np.int32
    prompt = serve_mod.synthetic_token_batch(np.random.default_rng(seed), batch, prompt_len,
                                             cfg.vocab)["tokens"]
    seq = np.concatenate([prompt, want[:, :-1]], axis=1)
    n = seq.shape[1]
    jb = {"tokens": jnp.asarray(seq)}
    if jcfg.family == "vlm":
        jb["image_embeds"] = jnp.zeros((batch, jcfg.n_patches, jcfg.d_model), jnp.bfloat16)
        jb["mrope_pos"] = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :, None],
                                           (batch, n, 3))
    if jcfg.family == "audio":
        jb["enc_frames"] = jnp.zeros((batch, jcfg.encoder_seq, jcfg.d_model), jnp.bfloat16)
    logits = f32(JT.forward(jcfg, jax.tree_util.tree_map(jnp.asarray, jp), jb)[0])
    logits = logits[:, prompt_len - 1:]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    margin_tol = 2 * TOL * np.abs(logits).max()
    for row in range(batch):
        differ = np.nonzero(got.tokens[row] != want[row])[0]
        if differ.size:
            assert margin[row, differ[0]] < margin_tol, (row, differ[0], margin[row, differ[0]])


def test_stub_frontend_is_the_jax_packages_and_refuses_a_short_vlm_prompt():
    """The stubs of the JAX package's serve_loop and train_loop (zeros;
    M-RoPE arange on all three streams); a VLM prompt shorter than the
    image raises, in serve_loop and in train_loop."""
    vl, wh = get_config(QWEN_VL), get_config(WHISPER)
    stub = serve_mod.stub_frontend(vl, 2, 20, "cpu")
    assert sorted(stub) == ["image_embeds", "mrope_pos"]
    assert stub["image_embeds"].shape == (2, 16, vl.d_model)
    assert stub["image_embeds"].dtype == torch.bfloat16 and not stub["image_embeds"].any()
    assert np.array_equal(stub["mrope_pos"].numpy(),
                          np.broadcast_to(np.arange(20)[None, :, None], (2, 20, 3)))
    stub = serve_mod.stub_frontend(wh, 2, 20, "cpu")
    assert sorted(stub) == ["enc_frames"] and stub["enc_frames"].shape == (2, 64, wh.d_model)
    assert serve_mod.stub_frontend(get_config("qwen2-7b-smoke"), 2, 20, "cpu") == {}
    with pytest.raises(ValueError, match="n_patches=16"):
        serve_mod.serve_loop(QWEN_VL, batch=1, prompt_len=8, new_tokens=1, device="cpu")
    with pytest.raises(ValueError, match="n_patches=16"):
        TL.train_loop(QWEN_VL, steps=1, batch=1, seq=8, device="cpu")


@pytest.mark.parametrize("arch", ARCH_PAIR)
def test_serve_cli_runs_the_new_archs_on_the_cpu(arch, capsys):
    serve_mod.main(["--arch", arch, "--batch", "2", "--prompt-len", "20", "--new-tokens", "2",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "device=cpu" in out and "steady-state decode" in out


# --------------------------------------------------------------------------
# Training against the JAX package
# --------------------------------------------------------------------------

def _jpath(path) -> tuple[str, ...]:
    return tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _port_grads(cfg, params, batch, remat=False):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = TT.lm_loss(cfg, tree_unflatten(params, leaves), batch, remat=remat)
    return float(loss.detach()), tree_unflatten(params, torch.autograd.grad(loss, leaves))


@pytest.mark.parametrize("arch", ARCH_PAIR)
def test_lm_loss_and_grads_match_jax(arch):
    """The weighted NLL (fl_weights with a zero) with the family's inputs,
    and its gradient against jax.value_and_grad on the bf16 draws: loss 5e-3
    absolute, global grad norm 2e-2 relative, every leaf (the encoder's and
    the cross-attentions' included, each non-zero) within 5e-2 relative
    Frobenius error; remat=True is bitwise remat=False."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    p_np = jax_llm_params(jcfg, 3)
    jb, tb = _inputs(jcfg, 4, 33, seed=4)
    jb["labels"], jb["tokens"] = jb["tokens"][:, 1:], jb["tokens"][:, :-1]
    tb["labels"], tb["tokens"] = tb["tokens"][:, 1:], tb["tokens"][:, :-1]
    if "mrope_pos" in jb:
        jb["mrope_pos"], tb["mrope_pos"] = jb["mrope_pos"][:, :-1], tb["mrope_pos"][:, :-1]
    w = np.asarray([1.5, 0.0, 2.0, 0.5], np.float32)
    jb["fl_weights"], tb["fl_weights"] = jnp.asarray(w), torch.from_numpy(w)
    fn = jax.jit(jax.value_and_grad(lambda p, b: JT.lm_loss(jcfg, p, b), has_aux=True))
    (jloss, _), jgrads = fn(jax.tree_util.tree_map(jnp.asarray, p_np), jb)
    params = TT.params_from_jax(tcfg, p_np)
    loss, grads = _port_grads(tcfg, params, tb)
    assert abs(loss - float(jloss)) <= LOSS_ATOL
    g = [(p, f32(torch.stack(v) if isinstance(v, list) else v)) for p, v in jax_leaves(grads)]
    want = [(_jpath(p), f32(v)) for p, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    assert [p for p, _ in g] == [p for p, _ in want]
    norm = lambda flat: float(np.sqrt(sum((a ** 2).sum() for _, a in flat)))  # noqa: E731
    assert abs(norm(g) - norm(want)) <= GNORM_RTOL * norm(want)
    for (path, a), (_, b) in zip(g, want):
        assert a.shape == b.shape, path
        assert np.linalg.norm(a - b) <= LEAF_RTOL * np.linalg.norm(b), path
    grads_of = dict(g)
    if tcfg.is_encoder_decoder:
        for path in (("encoder", "attn", "wq", "w"), ("encoder", "ffn", "down", "w"),
                     ("s0_l0", "cross", "wk", "w"), ("enc_final_ln", "g")):
            assert np.linalg.norm(grads_of[path]) > 0, path
    rloss, rgrads = _port_grads(tcfg, params, tb, remat=True)
    assert rloss == loss
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(rgrads), tree_leaves(grads)))


_JAX_LOOP: dict = {}


def _jax_train_loop(arch, p_np, monkeypatch):
    """The JAX package's train_loop(arch, steps=3, fl=True) on p_np: the
    loss and grad norm of every step as its jitted step computed them."""
    seen = []
    real_step = JL.make_train_step

    def recording_step(cfg, opt, ctx, remat):
        step = real_step(cfg, opt, ctx, remat=remat)

        def wrapped(params, opt_state, batch):
            out = step(params, opt_state, batch)
            jax.debug.callback(lambda l, g: seen.append((float(l), float(g))),
                               out[2]["loss"], out[2]["grad_norm"])
            return out
        return wrapped

    with monkeypatch.context() as m:
        m.setattr(JL, "make_train_step", recording_step)
        m.setattr(JL, "init_params", lambda cfg, key: jax.tree_util.tree_map(jnp.asarray, p_np))
        JL.train_loop(arch, steps=3, fl=True)
    return seen


@pytest.mark.parametrize("arch", ARCH_PAIR)
def test_train_loop_matches_jax(arch, monkeypatch):
    """train_loop(steps=3, fl=True) on the CPU, with the stub frontends,
    against the JAX package's train_loop on the same draws: loss and grad
    norm of every step at the training gates."""
    p_np = jax_llm_params(jax_get_config(arch), 3)
    want = _jax_train_loop(arch, p_np, monkeypatch)
    res = TL.train_loop(arch, steps=3, fl=True, device="cpu",
                        params=TT.params_from_jax(get_config(arch), p_np))
    assert len(want) == len(res.losses) == 3
    for loss, gn, (jloss, jgn) in zip(res.losses, res.grad_norms, want):
        assert abs(loss - jloss) <= LOSS_ATOL
        assert abs(gn - jgn) <= GNORM_RTOL * jgn


def test_checkpoint_with_the_encoder_restores_in_the_jax_package(tmp_path):
    """The port writes whisper-base-smoke's parameters with the encoder
    stacked as the JAX tree holds it; the JAX package restores them
    bitwise."""
    jcfg, tcfg = jax_get_config(WHISPER), get_config(WHISPER)
    p_np = jax_llm_params(jcfg, 3)
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    save_checkpoint(str(tmp_path / "t.npz"), TT.params_from_jax(tcfg, p_np), step=2)
    back, step = jax_restore_checkpoint(str(tmp_path / "t.npz"), jp)
    assert step == 2
    with np.load(tmp_path / "t.npz") as data:
        assert data["__bf16__encoder|attn|wq|w"].shape[0] == jcfg.n_encoder_layers
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                 jax.tree_util.tree_flatten_with_path(jp)[0]):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a).view(np.uint8),
                                                     np.asarray(b).view(np.uint8)), path


# --------------------------------------------------------------------------
# examples/torch_serve_model.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_torch_serve_model_example_runs_every_arch_on_the_cpu(arch, capsys):
    """The example's prefill + decode of every arch's smoke config agrees
    with its own full forward pass within 4e-2 (it raises otherwise)."""
    spec = importlib.util.spec_from_file_location("torch_serve_model", EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    err = example.main(["--arch", arch + "-smoke", "--prompt-len", "20", "--new-tokens", "3",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out and "prefill + decode vs full forward" in out
    assert 0 <= err < TOL


# --------------------------------------------------------------------------
# qwen2-vl-2b's full depth: the zero-patch stub against seeded patches
# --------------------------------------------------------------------------

VL_DEPTH = 28          # qwen2-vl-2b's layers


def _finite(tree) -> bool:
    return all(np.isfinite(f32(torch.stack(v) if isinstance(v, list) else v)).all()
               for _, v in jax_leaves(tree))


def test_vlm_gradient_on_zero_patches_is_not_finite_at_full_depth():
    """qwen2-vl-2b-smoke at 28 layers: on the stub's zero patches JAX's and
    the port's gradients are not finite; on seeded patches (0.02) both are,
    loss within 5e-3 and global grad norm within 2e-2 of JAX's."""
    jcfg = dataclasses.replace(jax_get_config(QWEN_VL), n_layers=VL_DEPTH)
    tcfg = dataclasses.replace(get_config(QWEN_VL), n_layers=VL_DEPTH)
    p_np = jax_llm_params(jcfg, 3)
    jb, tb = _inputs(jcfg, 2, 33, seed=4)
    jb["labels"], jb["tokens"] = jb["tokens"][:, 1:], jb["tokens"][:, :-1]
    tb["labels"], tb["tokens"] = tb["tokens"][:, 1:], tb["tokens"][:, :-1]
    jb["mrope_pos"], tb["mrope_pos"] = jb["mrope_pos"][:, :-1], tb["mrope_pos"][:, :-1]
    jb["fl_weights"], tb["fl_weights"] = jnp.ones(2), torch.ones(2)
    fn = jax.jit(jax.value_and_grad(lambda p, b: JT.lm_loss(jcfg, p, b), has_aux=True))
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    for patches in ("zero", "seeded"):
        if patches == "zero":
            zj, zt = {**jb, "image_embeds": jnp.zeros_like(jb["image_embeds"])}, {
                **tb, "image_embeds": torch.zeros_like(tb["image_embeds"])}
        else:
            zj, zt = jb, tb
        (jloss, _), jgrads = fn(jp, zj)
        loss, grads = _port_grads(tcfg, TT.params_from_jax(tcfg, p_np), zt)
        jflat = [f32(v) for v in jax.tree_util.tree_leaves(jgrads)]
        jfinite = all(np.isfinite(v).all() for v in jflat)
        assert jfinite == _finite(grads) == (patches == "seeded"), patches
        if patches == "seeded":
            assert abs(loss - float(jloss)) <= LOSS_ATOL
            gn = float(np.sqrt(sum((f32(torch.stack(v) if isinstance(v, list) else v) ** 2).sum()
                                   for _, v in jax_leaves(grads))))
            jgn = float(np.sqrt(sum((v ** 2).sum() for v in jflat)))
            assert abs(gn - jgn) <= GNORM_RTOL * jgn


def test_train_loop_trains_the_vlm_at_full_depth_on_the_frontend_it_is_given():
    """train_loop on qwen2-vl-2b-smoke at 28 layers: on its default stub
    (zero patches) the grad norm is not finite; with `frontend` (seeded
    patches of scale 0.02 on the 3-D M-RoPE grid) every loss and grad norm
    is."""
    cfg = dataclasses.replace(get_config(QWEN_VL), n_layers=VL_DEPTH)
    kw = dict(steps=2, batch=2, seq=32, fl=True, device="cpu", log_every=2)
    stub = TL.train_loop(cfg, **kw)
    assert not np.isfinite(stub.grad_norms).all()
    gen = torch.Generator().manual_seed(1)
    frontend = {"image_embeds": (0.02 * torch.randn(2, cfg.n_patches, cfg.d_model,
                                                    generator=gen)).bfloat16(),
                "mrope_pos": TLY.mrope_grid(2, 32, cfg.n_patches)}
    fed = TL.train_loop(cfg, frontend=frontend, **kw)
    assert np.isfinite(fed.losses).all() and np.isfinite(fed.grad_norms).all()
