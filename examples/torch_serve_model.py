"""Serving example of the PyTorch port (the counterpart of
`examples/serve_model.py`): prefill a prompt, then decode tokens through
the ring-buffer KV/state caches with the same serve step `serve_loop`
runs, on an arch's reduced config, with a check of prefill + decode
against the full forward pass over the whole sequence.

  PYTHONPATH=src python examples/torch_serve_model.py --arch rwkv6-7b-smoke
  PYTHONPATH=src python examples/torch_serve_model.py --arch whisper-base-smoke --device cpu

Any of the ten archs' `-smoke` configs (or a full one, where it fits the
card).  Runs on the current CUDA device (and raises without one), or on the
CPU with `--device cpu`, with the config's own attn_impl / rwkv_wkv_impl.
The audio arch gets random encoder frames (scale 0.02), the VLM arch random
patch embeddings (scale 0.02) and M-RoPE positions arange(S) on all three
streams, as the JAX example feeds them.  Returns the check's relative
error (max |diff| / max |full|) and raises SystemExit above 4e-2, the JAX
package's serving tolerance.
"""
import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.transformer import forward, init_params  # noqa: E402
from repro_torch.train.serve_step import make_serve_step  # noqa: E402
from repro_torch.train.tree import tree_leaves  # noqa: E402

TOL = 4e-2


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b-smoke")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None, help="default: the current CUDA device")
    a = ap.parse_args(argv)

    cfg = get_config(a.arch)
    dev = resolve_device(a.device)
    gen = torch.Generator(dev).manual_seed(0)
    params = init_params(cfg, gen)
    b, s, nd = 2, a.prompt_len, a.new_tokens
    toks = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev, dtype=torch.int32)

    # The frontends' inputs, sized for the whole sequence (prompt + decode).
    extras = {}
    if cfg.family == "vlm":
        extras["image_embeds"] = 0.02 * torch.randn(b, cfg.n_patches, cfg.d_model,
                                                    generator=gen, device=dev).bfloat16()
        mrope = torch.arange(s + nd, dtype=torch.int32, device=dev)[None, :, None]
        extras["mrope_pos"] = mrope.expand(b, s + nd, 3)
    if cfg.family == "audio":
        extras["enc_frames"] = 0.02 * torch.randn(b, cfg.encoder_seq, cfg.d_model,
                                                  generator=gen, device=dev).bfloat16()
    prompt = dict(extras, tokens=toks)
    if "mrope_pos" in prompt:
        prompt["mrope_pos"] = extras["mrope_pos"][:, :s]

    print(f"arch={cfg.name} family={cfg.family} device={dev}")
    t0 = time.perf_counter()
    logits, _, cache = forward(cfg, params, prompt, mode="prefill", cache_headroom=nd)
    print(f"prefill {s} tokens: {time.perf_counter() - t0:.2f}s")
    n_cache = sum(x.numel() * x.element_size() for x in tree_leaves(cache))
    print(f"cache size: {n_cache / 2**20:.2f} MiB")

    step = make_serve_step(cfg)
    positions = torch.arange(s, s + nd, dtype=torch.int32, device=dev)
    tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    out_tokens, step_logits = [tok], [logits[:, -1]]
    t0 = time.perf_counter()
    for d in range(nd):
        db = {"token": tok, "pos": positions[d]}
        if "mrope_pos" in extras:
            db["mrope_pos"] = extras["mrope_pos"][:, s + d:s + d + 1]
        tok, lg, cache = step(params, db, cache)
        out_tokens.append(tok)
        step_logits.append(lg[:, -1])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"decoded {nd} tokens in {dt:.2f}s ({dt / nd * 1e3:.0f} ms/token)")
    gen_toks = torch.cat(out_tokens, dim=1)
    print("greedy continuation (batch 0):", gen_toks[0, 1:].tolist())

    # The check: the full forward pass over prompt + the fed tokens gives at
    # each position the logits prefill (last prompt position) and each
    # decode step gave.
    full = forward(cfg, params, dict(extras, tokens=torch.cat([toks, gen_toks[:, :nd]], 1)))[0]
    want = full[:, s - 1:].float()
    got = torch.stack(step_logits, dim=1).float()
    err = float((got - want).abs().max() / want.abs().max())
    print(f"prefill + decode vs full forward: rel_err={err:.3e} (limit {TOL})")
    if not err < TOL:
        raise SystemExit(f"prefill + decode disagree with the full forward pass ({err:.3e})")
    return err


if __name__ == "__main__":
    main()
