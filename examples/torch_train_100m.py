"""End-to-end LM training at ~100M parameters on the PyTorch port
(`repro_torch`): the port's counterpart of `examples/train_100m.py`, with
the same scaled-down qwen2-style dense config, the synthetic token
pipeline, FL cohort weights from the Stackelberg planner at every step (the
paper's technique as a feature of the training step), and a checkpoint
every --ckpt-every steps in the JAX package's `.npz` layout (so
`repro.checkpoint.restore_checkpoint` reads it too).

  PYTHONPATH=src python examples/torch_train_100m.py --steps 100
  PYTHONPATH=src python examples/torch_train_100m.py --steps 2 --batch 1 --seq 8 \\
      --device cpu --out /tmp/ckpt.npz

It runs on the current CUDA device unless ``--device cpu`` is given.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core import RoundPolicy, WirelessConfig, init_aou
from repro_torch.core.wireless import sample_topology
from repro_torch.data.pipeline import synthetic_lm_stream
from repro_torch.device import resolve_device
from repro_torch.launch.train import fl_round_weights
from repro_torch.models.transformer import init_params, param_count
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import make_train_step


def make_100m_config():
    """~100M-param dense decoder in the qwen2 family."""
    base = get_config("qwen2-7b")
    return dataclasses.replace(
        base, name="qwen2-100m", n_layers=8, d_model=640, n_heads=10,
        n_kv_heads=2, d_ff=2560, vocab=32768, sliding_window=0,
        long_context="", optimizer="adamw",
    )


def main(argv=None):
    """Trains and returns the final parameters."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--out", default="results/torch_ckpt_100m.npz")
    ap.add_argument("--device", default=None, help="cpu, or cuda[:i] (the default)")
    a = ap.parse_args(argv)

    dev = resolve_device(a.device)
    cfg = make_100m_config()
    params = init_params(cfg, torch.Generator(dev).manual_seed(0))
    print(f"{cfg.name}: {param_count(params)/1e6:.1f}M params on {dev}")

    opt = make_optimizer("adamw", a.lr)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, remat=False)
    stream = synthetic_lm_stream(0, a.batch, a.seq, cfg.vocab)

    # FL cohort weighting from the Stackelberg planner (8 cohorts).
    rng = np.random.default_rng(0)
    wcfg = WirelessConfig(n_devices=8, n_subchannels=4)
    fl_state = {"topo": sample_topology(rng, wcfg), "aou": init_aou(8)}
    beta = rng.integers(10, 50, 8).astype(np.float64)
    policy = RoundPolicy()

    t0 = time.time()
    for step in range(a.steps):
        b = next(stream)
        w, plan, lat = fl_round_weights(fl_state, beta, wcfg, rng, policy)
        row_w = w[np.arange(a.batch) % 8]
        if row_w.sum() == 0:
            row_w = np.ones(a.batch)
        batch = {
            "tokens": torch.from_numpy(b["tokens"]).to(dev),
            "labels": torch.from_numpy(b["labels"]).to(dev),
            "fl_weights": torch.from_numpy(row_w.astype(np.float32)).to(dev),
        }
        params, opt_state, m = step_fn(params, opt_state, batch)
        if step % 10 == 0 or step == a.steps - 1:
            print(f"step {step:4d}  loss {float(m['loss']):.4f}  "
                  f"gnorm {float(m['grad_norm']):.2f}  "
                  f"round_latency {lat:.2f}s  "
                  f"({(time.time()-t0)/(step+1):.2f}s/step)")
        if a.ckpt_every and (step + 1) % a.ckpt_every == 0:
            save_checkpoint(a.out, params, step=step + 1)
            print(f"  checkpoint -> {a.out}")
    print(f"done in {time.time()-t0:.0f}s")
    return params


if __name__ == "__main__":
    main()
