"""Training driver of the model zoo (PyTorch copy of the JAX package's
`launch/train.py`): synthetic Zipf token batches, AdamW, and with `--fl`
the paper's Stackelberg round planner setting each cohort's weight in the
loss (eq. 42) at every step.

  python -m repro_torch.launch.train --arch qwen2-7b-smoke --steps 20
  python -m repro_torch.launch.train --arch rwkv6-7b-smoke --fl --steps 50

runs on the current CUDA device (and raises without one).  `train_loop`
also takes an `ArchConfig` (a full-width config with its depth cut, say),
`device="cpu"`, and `params` (from `init_params` or `params_from_jax`, on
that device), which the loop's donated step updates in place
(`make_train_step(donate=True)`).  The audio and VLM families train on the
JAX package's stub frontends (`serve.stub_frontend`: zero frames or patch
embeddings, M-RoPE arange) unless `frontend` gives their inputs; a VLM
`seq` shorter than n_patches raises ValueError.  At qwen2-vl-2b's full
depth the zero patches make the gradient non-finite, in the JAX package
too: every patch row's residual stays exactly 0 (the Q/K/V biases start
at 0), and each RMS norm's backward scales that row's gradient by
1/sqrt(eps), layer after layer.  Train it on patch embeddings that are
not all zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import ArchConfig, get_config
from ..core import RoundPolicy, WirelessConfig, init_aou, plan_round
from ..core.wireless import sample_channel_gains, sample_topology
from ..data.pipeline import synthetic_lm_stream
from ..device import resolve_device
from ..models.transformer import init_params, param_count
from ..train.optimizer import make_optimizer
from ..train.train_step import make_train_step
from .serve import stub_frontend

__all__ = ["TrainResult", "fl_round_weights", "train_loop", "main"]


def fl_round_weights(state, beta, wcfg, rng, policy) -> tuple[np.ndarray, object, float]:
    """One Stackelberg round -> per-cohort weights alpha*beta*S*psi (eq. 42)."""
    topo, aou = state["topo"], state["aou"]
    h2 = sample_channel_gains(rng, wcfg, topo)
    plan = plan_round(aou, beta, h2, wcfg, rng, policy=policy)
    state["aou"] = plan.aou_next
    alpha = aou.weights
    w = alpha * beta * plan.transmitted.astype(np.float64)
    return w, plan, plan.latency_s


@dataclasses.dataclass(frozen=True)
class TrainResult:
    losses: list[float]
    grad_norms: list[float]      # before the clip
    step_s: list[float]          # host wall time of each step, its one host read included
    n_params: int
    wireless_latency_s: float    # the planner's simulated round latencies, summed (fl=True)


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on `dev`; to the card from pinned memory without
    waiting, so the step's only host read is its metrics."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


def train_loop(arch_or_cfg: str | ArchConfig, *, steps: int = 20, batch: int = 8,
               seq: int = 128, lr: float = 3e-4, fl: bool = False, n_cohorts: int = 8,
               seed: int = 0, log_every: int = 1, device=None, params=None,
               frontend: dict | None = None) -> TrainResult:
    cfg = get_config(arch_or_cfg) if isinstance(arch_or_cfg, str) else arch_or_cfg
    dev = resolve_device(device)
    if params is None:
        params = init_params(cfg, torch.Generator(dev).manual_seed(seed))
    n_params = param_count(params)
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M device={dev}")

    opt = make_optimizer("adamw" if cfg.optimizer == "adafactor" else cfg.optimizer, lr)
    opt_state = opt.init(params)
    # The loop never reads the old parameters or state again: donate them.
    step_fn = make_train_step(cfg, opt, remat=False, donate=True)

    rng = np.random.default_rng(seed)
    stream = synthetic_lm_stream(seed, batch, seq, cfg.vocab)
    # The audio and VLM families' modality inputs, the same every step.
    if frontend is None:
        frontend = stub_frontend(cfg, batch, seq, dev)

    fl_state = None
    if fl:
        wcfg = WirelessConfig(n_devices=n_cohorts, n_subchannels=max(2, n_cohorts // 4))
        fl_state = {
            "topo": sample_topology(rng, wcfg),
            "aou": init_aou(n_cohorts),
        }
        beta = rng.integers(10, 50, n_cohorts).astype(np.float64)
        policy = RoundPolicy()

    losses, gnorms, step_s = [], [], []
    wall = time.perf_counter()
    total_latency = 0.0
    for step in range(steps):
        t0 = time.perf_counter()
        b = next(stream)
        example = {"tokens": _to_device(b["tokens"], dev),
                   "labels": _to_device(b["labels"], dev), **frontend}
        if fl:
            w, plan, lat = fl_round_weights(fl_state, beta, wcfg, rng, policy)
            total_latency += lat
            # cohorts -> batch rows (round-robin)
            row_w = w[np.arange(batch) % n_cohorts]
            if row_w.sum() == 0:
                row_w = np.ones(batch)
        else:
            row_w = np.ones(batch)
        example["fl_weights"] = _to_device(row_w.astype(np.float32), dev)

        params, opt_state, metrics = step_fn(params, opt_state, example)
        loss, gnorm = torch.stack([metrics["loss"], metrics["grad_norm"]]).tolist()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        gnorms.append(gnorm)
        if step % log_every == 0:
            msg = f"step {step:4d} loss {loss:.4f} gnorm {gnorm:.3f}"
            if fl:
                msg += f" round_latency {lat:.2f}s tx={int(plan.transmitted.sum())}"
            print(msg)
    dt = time.perf_counter() - wall
    print(f"done: {steps} steps in {dt:.1f}s; loss {losses[0]:.4f} -> {losses[-1]:.4f}"
          + (f"; simulated wireless latency {total_latency:.1f}s" if fl else ""))
    return TrainResult(losses=losses, grad_norms=gnorms, step_s=step_s, n_params=n_params,
                       wireless_latency_s=total_latency)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b-smoke")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--fl", action="store_true",
                    help="drive per-cohort weights from the Stackelberg round planner")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    train_loop(a.arch, steps=a.steps, batch=a.batch, seq=a.seq, lr=a.lr,
               fl=a.fl, seed=a.seed)


if __name__ == "__main__":
    main()
