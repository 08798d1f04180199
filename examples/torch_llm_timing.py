"""qwen2-7b's serving and training times on the card, at the shapes of
`chip_smoke.py`'s phases 11 and 13, for comparing two checkouts of the
PyTorch port (`repro_torch`) on one card: run it once with each
checkout's `src` on PYTHONPATH, alternating (a, b, b, a).

  PYTHONPATH=src python examples/torch_llm_timing.py --label change
  PYTHONPATH=/path/to/other/checkout/src python examples/torch_llm_timing.py --label parent

Serving: `serve_loop` on the kernel path (attn_impl="pallas") at full
width and depth (28 layers), batch 4, prompt 512, 32 new tokens, random
weights from seed 0; one cold run and --warm warm runs on the same weights.
Training: `train_loop(fl=True)` at full width and 4 layers, batch 8,
seq 128, lr 3e-4, 20 steps; the mean of steps 2-19 and the peak memory.
Prints the card's name and power limit, then one JSON line.
"""
import argparse
import dataclasses
import gc
import json
import subprocess

import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import serve_loop
from repro_torch.launch.train import train_loop
from repro_torch.models.transformer import init_params

ARCH = "qwen2-7b"
SERVE = dict(batch=4, prompt_len=512, new_tokens=32, seed=0)
TRAIN = dict(batch=8, seq=128, lr=3e-4, seed=0)
TRAIN_LAYERS, TRAIN_STEPS = 4, 20


def serve_times(warm: int) -> list[dict]:
    cfg = dataclasses.replace(get_config(ARCH), attn_impl="pallas")
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SERVE["seed"]))
    runs = []
    for _ in range(1 + warm):
        r = serve_loop(cfg, device="cuda", params=params, log_every=SERVE["new_tokens"], **SERVE)
        runs.append({"prefill_s": r.prefill_s, "prefill_tok_s": r.prefill_tok_s,
                     "decode_ms_per_step": 1e3 * r.decode_s / SERVE["new_tokens"]})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def train_times() -> dict:
    cfg = dataclasses.replace(get_config(ARCH), n_layers=TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    res = train_loop(cfg, steps=TRAIN_STEPS, fl=True, device="cuda", log_every=TRAIN_STEPS,
                     **TRAIN)
    warm = res.step_s[2:]
    return {"layers": TRAIN_LAYERS, "steps": TRAIN_STEPS,
            "warm_ms_per_step": 1e3 * sum(warm) / len(warm),
            "tokens_s": TRAIN["batch"] * TRAIN["seq"] * len(warm) / sum(warm),
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "last_loss": res.losses[-1]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--warm", type=int, default=2)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_llm_timing: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    out = {"label": a.label, "card": card, "arch": ARCH, "serve": serve_times(a.warm),
           "train": train_times()}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
