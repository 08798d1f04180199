"""Serving driver of the model zoo: batched prefill + greedy decode loop over
the ring caches (PyTorch copy of the JAX package's `launch/serve.py`).

  python -m repro_torch.launch.serve --arch qwen2-7b --batch 4 \
      --prompt-len 512 --new-tokens 32

runs on the current CUDA device (and raises without one; `--device cpu`
runs the plain versions on the CPU), with the config's own `attn_impl` /
`rwkv_wkv_impl`.  `serve_loop` also takes an `ArchConfig`, which is how a
caller selects the kernel path ("pallas"), and `device="cpu"`.

The audio and VLM families get the stub frontends of the JAX package's
`serve_loop` (`stub_frontend`): zero encoder frames (B, encoder_seq, d),
or zero patch embeddings (B, n_patches, d) with M-RoPE positions arange(S)
on all three streams, and position p on all three for the decode step at
p.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import ArchConfig, get_config
from ..data.pipeline import synthetic_token_batch
from ..device import resolve_device
from ..models.transformer import clone_cache, init_params, param_count
from ..train.serve_step import make_prefill_step, make_serve_step
from .step_analysis import tree_nbytes

__all__ = ["ServeResult", "serve_loop", "stub_frontend", "main"]


@dataclasses.dataclass(frozen=True)
class ServeResult:
    tokens: np.ndarray       # (B, new_tokens + 1) int32: the prefill's token, then the decoded
    prefill_s: float         # prefill wall time, first call in the loop included
    decode_s: float          # the timed decode steps (the warm-up step excluded)
    batch: int
    prompt_len: int
    new_tokens: int
    cache_bytes: int = 0     # the prefill cache's summed bytes (its decode slots included)

    @property
    def prefill_tok_s(self) -> float:
        return self.batch * self.prompt_len / self.prefill_s

    @property
    def decode_tok_s(self) -> float:
        return self.batch * self.new_tokens / self.decode_s


def stub_frontend(cfg: ArchConfig, batch: int, seq: int, device) -> dict:
    """The stubbed modality inputs of a (batch, seq) token batch, as the JAX
    package's `serve_loop` and `train_loop` build them: for the VLM family bf16
    zero `image_embeds` (B, n_patches, d) and `mrope_pos` = arange(seq) on
    all three streams (B, seq, 3) int32; for the audio family bf16 zero
    `enc_frames` (B, encoder_seq, d); else nothing.  (A VLM sequence
    shorter than n_patches cannot hold the patches: the forward pass
    raises ValueError.)"""
    out: dict = {}
    if cfg.family == "vlm":
        out["image_embeds"] = torch.zeros(batch, cfg.n_patches, cfg.d_model,
                                          dtype=torch.bfloat16, device=device)
        out["mrope_pos"] = torch.arange(seq, dtype=torch.int32, device=device)[
            None, :, None].expand(batch, seq, 3)
    if cfg.family == "audio":
        out["enc_frames"] = torch.zeros(batch, cfg.encoder_seq, cfg.d_model,
                                        dtype=torch.bfloat16, device=device)
    return out


def serve_loop(arch_or_cfg: str | ArchConfig, *, batch: int = 4, prompt_len: int = 64,
               new_tokens: int = 32, seed: int = 0, device=None, params=None,
               log_every: int = 8) -> ServeResult:
    """Prefill a seeded synthetic prompt batch, run one DISCARDED warm-up
    decode step (on a clone of the cache: decode updates the cache in
    place), then `new_tokens` timed greedy decode steps.  Tokens and
    positions stay on the device inside the loop; the generation is read to
    the host once, after it.  `params` (from `init_params` or
    `params_from_jax`, on `device`) default to `init_params` drawn from
    `seed`."""
    cfg = get_config(arch_or_cfg) if isinstance(arch_or_cfg, str) else arch_or_cfg
    dev = resolve_device(device)
    if params is None:
        params = init_params(cfg, torch.Generator(dev).manual_seed(seed))
    print(f"arch={cfg.name} family={cfg.family} "
          f"params={param_count(params)/1e6:.1f}M device={dev} "
          f"attn_impl={cfg.attn_impl} rwkv_wkv_impl={cfg.rwkv_wkv_impl}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(seed)
    toks = synthetic_token_batch(rng, batch, prompt_len, cfg.vocab)["tokens"]
    req = {"tokens": torch.from_numpy(toks).to(dev),
           **stub_frontend(cfg, batch, prompt_len, dev)}
    # Decode step d runs at position prompt_len + d (M-RoPE: on all three
    # streams); indexing these tensors with a Python int is a view, so no
    # host-to-device copy per step.
    positions = torch.arange(prompt_len, prompt_len + new_tokens + 1, dtype=torch.int32,
                             device=dev)
    mrope = positions[:, None, None, None].expand(-1, batch, 1, 3)

    def step_batch(tok, d):
        if cfg.family == "vlm":
            return {"token": tok, "pos": positions[d], "mrope_pos": mrope[d]}
        return {"token": tok, "pos": positions[d]}

    prefill = make_prefill_step(cfg, cache_headroom=new_tokens)
    serve = make_serve_step(cfg)

    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(params, req)
    cache_bytes = tree_nbytes(cache)
    tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    sync()
    t_prefill = time.perf_counter() - t0
    print(f"prefill {batch}x{prompt_len}: {t_prefill:.3f}s "
          f"({batch*prompt_len/t_prefill:.0f} tok/s)")

    # Warm-up: one DISCARDED decode step, so the timed loop below measures
    # steady-state decode only.  It gets a clone of the cache, because
    # decode writes the ring slot, the write index and the states in place.
    serve(params, step_batch(tok, 0), clone_cache(cache))
    sync()

    generated = [tok]
    t0 = time.perf_counter()
    for d in range(new_tokens):
        tok, logits, cache = serve(params, step_batch(tok, d), cache)
        generated.append(tok)
        if d % log_every == 0:
            print(f"  step {d:3d}/{new_tokens} dispatched")
    sync()
    dt = time.perf_counter() - t0
    print(f"decoded {new_tokens} tokens x {batch}: {dt:.3f}s "
          f"({batch*new_tokens/dt:.1f} tok/s steady-state decode)")
    tokens = torch.cat(generated, dim=1).cpu().numpy()
    return ServeResult(tokens=tokens, prefill_s=t_prefill, decode_s=dt, batch=batch,
                       prompt_len=prompt_len, new_tokens=new_tokens, cache_bytes=cache_bytes)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the current CUDA device")
    a = ap.parse_args(argv)
    serve_loop(a.arch, batch=a.batch, prompt_len=a.prompt_len,
               new_tokens=a.new_tokens, seed=a.seed, device=a.device)


if __name__ == "__main__":
    main()
