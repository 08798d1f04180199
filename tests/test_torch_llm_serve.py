"""The port's serving driver `repro_torch.launch.serve.serve_loop` on the
CPU: its tokens against the JAX package's `serve_loop` on the same
weights, the discarded warm-up step (decode updates the cache in place, so
the warm-up must run on a copy), and what the driver prints and returns.
"""
from _torch_oracle import f32, jax_llm_params  # noqa: I001  (alias first)

import ast
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import serve_loop as jax_serve_loop
from repro.models.transformer import forward as jax_forward
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models.transformer import params_from_jax
from repro_torch.train.serve_step import make_prefill_step, make_serve_step

TOL = 4e-2          # the JAX package's serving tolerance (tests/test_serving.py)
ROOT = Path(__file__).resolve().parents[1]
NEW = ["stablelm-3b-smoke", "yi-6b-smoke", "qwen1.5-110b-smoke", "granite-moe-3b-a800m-smoke"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: beside other test
    workers, torch's default (one thread per core each) oversubscribes the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_cfg(arch, impl):
    kw = {"attn_impl": "pallas", "rwkv_wkv_impl": "pallas"} if impl == "pallas" else {}
    return dataclasses.replace(get_config(arch), **kw)


@pytest.mark.parametrize("arch,impl", [("qwen2-7b-smoke", "ref"), ("qwen2-7b-smoke", "pallas"),
                                       ("rwkv6-7b-smoke", "ref"), ("rwkv6-7b-smoke", "pallas")]
                         + [(a, impl) for a in NEW for impl in ("ref", "pallas")])
def test_serve_loop_matches_jax_serve_loop(arch, impl):
    """Greedy tokens equal to the JAX package's serve_loop (its default
    "ref" paths) on the same weights, up to the first step where JAX's
    top-2 logit margin is under 2 x 4e-2 x max |logit| (both logits may move
    by the serving tolerance); from there the two generations may part."""
    batch, prompt_len, new_tokens, seed = 2, 16, 6, 5
    want = jax_serve_loop(arch, batch=batch, prompt_len=prompt_len, new_tokens=new_tokens,
                          seed=seed)
    cfg = _port_cfg(arch, impl)
    jp = jax_llm_params(jax_get_config(arch), seed)
    got = serve_mod.serve_loop(cfg, batch=batch, prompt_len=prompt_len, new_tokens=new_tokens,
                               seed=seed, device="cpu", params=params_from_jax(cfg, jp))
    assert got.tokens.shape == want.shape and got.tokens.dtype == np.int32
    # JAX's logits along its own generation: the full forward of prompt +
    # generated tokens, read at the positions that chose them.
    prompt = np.asarray(jax_serve_inputs(arch, batch, prompt_len, seed))
    seq = np.concatenate([prompt, want[:, :-1]], axis=1)
    logits = f32(jax_forward(jax_get_config(arch), jp, {"tokens": jnp.asarray(seq)})[0])
    logits = logits[:, prompt_len - 1:]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    margin_tol = 2 * TOL * np.abs(logits).max()
    for row in range(batch):
        differ = np.nonzero(got.tokens[row] != want[row])[0]
        if differ.size:
            assert margin[row, differ[0]] < margin_tol, (row, differ[0], margin[row, differ[0]])
    assert (got.tokens == want).mean() > 0.5


def jax_serve_inputs(arch, batch, prompt_len, seed):
    """The prompt the JAX package's serve_loop draws."""
    from repro.data.pipeline import synthetic_token_batch
    return synthetic_token_batch(np.random.default_rng(seed), batch, prompt_len,
                                 jax_get_config(arch).vocab)["tokens"]


@pytest.mark.parametrize("arch", ["qwen2-7b-smoke", "rwkv6-7b-smoke", "granite-moe-3b-a800m-smoke"])
def test_serve_loop_warmup_does_not_perturb_generation(arch, monkeypatch, capsys):
    """serve_loop, with its discarded warm-up step, decodes exactly what a
    plain prefill + decode loop without the warm-up decodes: the same
    tokens and, step by step, the same logits bit for bit.  Decode writes
    the ring slot, the write index and the recurrent states in place, so a
    warm-up on the live cache would shift every later step."""
    cfg = _port_cfg(arch, "pallas")
    batch, prompt_len, new_tokens, seed = 2, 12, 5, 3
    params = params_from_jax(cfg, jax_llm_params(jax_get_config(arch), seed))

    seen = []

    def recording_serve_step(cfg_):
        serve = make_serve_step(cfg_)

        def step(params_, batch_, cache):
            tok, logits, cache = serve(params_, batch_, cache)
            seen.append(logits.clone())
            return tok, logits, cache

        return step

    monkeypatch.setattr(serve_mod, "make_serve_step", recording_serve_step)
    got = serve_mod.serve_loop(cfg, batch=batch, prompt_len=prompt_len, new_tokens=new_tokens,
                               seed=seed, device="cpu", params=params)
    assert len(seen) == new_tokens + 1                    # one warm-up + the timed steps
    assert got.tokens.shape == (batch, new_tokens + 1) and got.tokens.dtype == np.int32
    logged = capsys.readouterr().out
    assert "steady-state decode" in logged and got.decode_tok_s > 0 and got.prefill_tok_s > 0

    prompt = serve_mod.synthetic_token_batch(np.random.default_rng(seed), batch, prompt_len,
                                             cfg.vocab)["tokens"]
    logits, cache = make_prefill_step(cfg, cache_headroom=new_tokens)(
        params, {"tokens": torch.from_numpy(prompt)})
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    serve, toks = make_serve_step(cfg), [tok]
    for d in range(new_tokens):
        tok, logits, cache = serve(params, {"token": tok,
                                            "pos": torch.tensor(prompt_len + d, dtype=torch.int32)},
                                   cache)
        assert torch.equal(logits, seen[d + 1]), d
        toks.append(tok)
    assert np.array_equal(got.tokens, torch.cat(toks, 1).numpy())


def test_serve_cli_refuses_a_silent_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the CLI runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_mod.main(["--arch", "qwen2-7b-smoke", "--prompt-len", "8", "--new-tokens", "2"])


@pytest.mark.parametrize("arch", NEW)
def test_serve_cli_runs_each_new_arch_on_the_cpu(arch, capsys):
    serve_mod.main(["--arch", arch, "--batch", "2", "--prompt-len", "8", "--new-tokens", "2",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "device=cpu" in out and "steady-state decode" in out


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py drives the port alone: no import of JAX or of the JAX
    package."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    bad = [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad and "repro_torch.launch.serve" in names
