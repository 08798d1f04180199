"""Multi-device EXECUTION demo (PyTorch counterpart of the JAX package's
`launch/multidevice_demo.py`): real FL-weighted train steps of an arch on
a (data, model) `DeviceMesh`, one process per rank, with the paper's
Stackelberg planner setting each cohort's weight at every step.

The sharded step is `train.train_step.make_train_step(ctx=ShardCtx(mesh))`:
parameters and AdamW moments held as this rank's blocks under the sharding
rules (`sharding.partition`), the batch split over `data`, the MoE
expert-parallel over `model`, attention sharded over `model`
(attn_shard="explicit", the default here) and the eq.-34 weighted loss.

  PYTHONPATH=src python -m repro_torch.launch.multidevice_demo --device cpu
      (gloo, data=2 x model=2: four processes on the CPU)
  PYTHONPATH=src python -m repro_torch.launch.multidevice_demo
      (NCCL, one rank per visible card: data = cards / model)

On the CPU the ranks meet through a `FileStore` in a fresh temporary
directory, so concurrent runs never collide on a port; on the card NCCL
takes one rank per visible GPU (it refuses two ranks on one device), and a
single card runs the mesh as a world of one, (1, 1), through an in-process
`HashStore`.  `spawn` joins its ranks with a timeout and kills them all if
one fails or hangs.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..configs import ArchConfig, get_config
from ..core import RoundPolicy, WirelessConfig, init_aou
from ..core.wireless import sample_topology
from ..data.pipeline import synthetic_lm_stream
from ..models.transformer import init_params, param_count, param_specs
from ..sharding.ctx import ShardCtx
from ..sharding.params import shard_tree
from ..sharding.partition import batch_shardings
from ..train.optimizer import make_optimizer
from ..train.train_step import make_grad_fn, make_train_step
from .mesh import smoke_mesh
from .train import fl_round_weights

__all__ = ["init_world", "spawn", "fl_batches", "shard_rows", "demo_ctx", "shardwise_grads",
           "leaf_gaps", "run_rank", "run", "main"]


def init_world(rank: int, world: int, backend: str, store_path: str | None = None) -> None:
    """Join the process group: a `FileStore` at `store_path`, or for a world
    of one with no path an in-process `HashStore`.  NCCL ranks take the
    card of their rank."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
    store = (dist.HashStore() if store_path is None and world == 1
             else dist.FileStore(store_path, world))
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)


def _entry(rank, fn, world, backend, store_path, args, results):
    init_world(rank, world, backend, store_path)
    # Barriers round the work: no rank tears its connections down while
    # another is still making its own.
    dist.barrier()
    results.put((rank, fn(rank, *args)))
    dist.barrier()
    dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), *, backend: str = "gloo",
          timeout: float = 900.0) -> list:
    """fn(rank, *args) on `world` ranks of a fresh process group, each its
    own process (`torch.multiprocessing`, spawned); returns every rank's
    result, in rank order.  A rank that raises ends the run (the others
    are terminated) and its error is raised here; a run that outlasts
    `timeout` seconds has every rank killed and raises TimeoutError.
    `fn` and its results must pickle."""
    import torch.multiprocessing as mp

    results = mp.get_context("spawn").SimpleQueue()
    got = {}

    def drain():      # read while the ranks run: a large result fills the pipe
        while not results.empty():
            rank, value = results.get()
            got[rank] = value

    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
        pctx = mp.start_processes(
            _entry, args=(fn, world, backend, os.path.join(tmp, "store"), args, results),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not pctx.join(timeout=1.0):
                drain()
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawn: {world} ranks still running after {timeout} s")
        finally:
            for p in pctx.processes:
                if p.is_alive():
                    p.kill()
        drain()
    if len(got) != world:
        raise RuntimeError(f"spawn: {len(got)} of {world} ranks returned a result")
    return [got[r] for r in range(world)]


def fl_batches(cfg: ArchConfig, batch: int, seq: int, seed: int):
    """The demo's steps' inputs, endlessly: a synthetic batch (tokens,
    labels) and its rows' weights from one Stackelberg round (cohort =
    batch row; all ones when no cohort transmits), as numpy, with the
    round's plan and latency.  Every rank draws the same from `seed`."""
    rng = np.random.default_rng(seed)
    wcfg = WirelessConfig(n_devices=batch, n_subchannels=max(2, batch // 2))
    fl_state = {"topo": sample_topology(rng, wcfg), "aou": init_aou(batch)}
    beta = rng.integers(10, 50, batch).astype(np.float64)
    stream = synthetic_lm_stream(seed, batch, seq, cfg.vocab)
    while True:
        b = next(stream)
        w, plan, lat = fl_round_weights(fl_state, beta, wcfg, rng, RoundPolicy())
        if w.sum() == 0:
            w = np.ones(batch)
        yield ({"tokens": b["tokens"], "labels": b["labels"],
                "fl_weights": w.astype(np.float32)}, plan, lat)


def shard_rows(x, ctx: ShardCtx):
    """This rank's data shard of a batch array (the whole batch where the
    data axes do not divide it: `ctx.batch_sharded` is False then)."""
    if not ctx.batch_sharded:
        return x
    n = x.shape[0] // ctx.dp_size
    return x[ctx.dp_rank * n:(ctx.dp_rank + 1) * n]


def demo_ctx(data: int, model: int, batch: int, seq: int, attn_shard: str,
             device_type: str) -> ShardCtx:
    """The demo's sharding context: a (data, model) mesh over the process
    group's ranks, the batch on `data` where the rules shard it."""
    mesh = smoke_mesh(data, model, device_type)
    token_sharded = batch_shardings({"tokens": np.zeros((batch, seq))}, mesh,
                                    ("data",))[("tokens",)][0] is not None
    return ShardCtx(mesh=mesh, dp_axes=("data",), attn_shard=attn_shard,
                    batch_sharded=token_sharded)


def shardwise_grads(cfg: ArchConfig, params, batch: dict, n_shards: int):
    """The meshed step's loss and gradient computed without a mesh, for a
    batch split over `n_shards` data shards: the unsharded `make_grad_fn`
    on each shard's rows, so each shard's MoE capacity is its own as on
    the mesh, each shard's loss and gradient weighted by its share of the
    batch's FL weight and summed.  Returns (loss, grads as float32 in
    `tree_leaves` order).  The mesh's load-balance aux is the whole
    batch's, which no shard sees alone, so this is the meshed step's
    function only where cfg.router_aux_coef is 0."""
    grad_fn = make_grad_fn(cfg, remat=False)
    w = batch["fl_weights"].to(torch.float32)
    total = torch.clamp(w.sum(), min=1e-9)
    n = w.shape[0] // n_shards
    loss, grads = 0.0, None
    for d in range(n_shards):
        rows = {k: v[d * n:(d + 1) * n] for k, v in batch.items()}
        share = torch.clamp(w[d * n:(d + 1) * n].sum(), min=1e-9) / total
        g, m = grad_fn(params, rows)
        g = [x.to(torch.float32) * share for x in g]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        loss += float(m["loss"] * share)
    return loss, grads


def leaf_gaps(got: list, want: list) -> list[float]:
    """||got - want|| / ||want|| (Frobenius, float64) of each pair of
    leaves; 0 where both are zero, inf where only `want` is."""
    gaps = []
    for a, b in zip(got, want):
        a, b = a.double(), b.double()
        num, den = float(torch.linalg.vector_norm(a - b)), float(torch.linalg.vector_norm(b))
        gaps.append(num / den if den > 0 else (0.0 if num == 0 else float("inf")))
    return gaps


def run_rank(cfg: ArchConfig, *, steps: int = 8, batch: int = 8, seq: int = 64,
             data: int = 1, model: int = 1, seed: int = 0, lr: float = 1e-3,
             attn_shard: str = "explicit", params=None, device=None,
             log: bool = True) -> dict:
    """This rank's part of the demo, inside an initialised process group of
    data * model ranks: the (data, model) mesh, the parameters (`params`,
    whole, on `device`; else `init_params` from `seed` with ep_size=model)
    cut to this rank's blocks, AdamW on them, and `steps` donated sharded
    steps, each on a synthetic batch weighted by one Stackelberg round.
    Returns {"losses", "grad_norms", "step_s" (each step's wall seconds,
    to its metrics' read), "params" (this rank's blocks), "n_params"}."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
        else torch.device("cpu"))
    ctx = demo_ctx(data, model, batch, seq, attn_shard, dev.type)
    if params is None:
        params = init_params(cfg, torch.Generator(dev).manual_seed(seed), ep_size=model)
    n_params = param_count(params)
    params = shard_tree(params, param_specs(cfg, ctx.mesh, model), ctx.mesh)
    opt = make_optimizer("adamw", lr)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, remat=False, donate=True, ctx=ctx)
    rank = dist.get_rank()
    if log and rank == 0:
        print(f"{cfg.name}: {n_params / 1e6:.2f}M params on a {data}x{model} mesh "
              f"({dist.get_world_size()} ranks, {dist.get_backend()}, "
              f"attn_shard={attn_shard})", flush=True)

    batches = fl_batches(cfg, batch, seq, seed)

    losses, gnorms, step_s = [], [], []
    t0 = time.perf_counter()
    for step in range(steps):
        t_step = time.perf_counter()
        b, plan, lat = next(batches)
        ex = {name: torch.as_tensor(shard_rows(x, ctx), device=dev) for name, x in b.items()}
        params, opt_state, m = step_fn(params, opt_state, ex)
        loss, gnorm = torch.stack([m["loss"], m["grad_norm"]]).tolist()
        step_s.append(time.perf_counter() - t_step)
        losses.append(loss)
        gnorms.append(gnorm)
        if log and rank == 0:
            print(f"step {step} loss {loss:.4f} gnorm {gnorm:.3f} "
                  f"tx={int(plan.transmitted.sum())}/{batch} latency={lat:.2f}s", flush=True)
    if log and rank == 0:
        print(f"{steps} sharded steps in {time.perf_counter() - t0:.1f}s; "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}", flush=True)
    return {"losses": losses, "grad_norms": gnorms, "step_s": step_s, "params": params,
            "n_params": n_params}


def _demo_rank(rank, arch, device, kw):
    return run_rank(get_config(arch), device=device, **kw)["losses"]


def run(arch: str = "granite-moe-3b-a800m-smoke", steps: int = 8, batch: int = 8,
        seq: int = 64, data: int | None = None, model: int | None = None, seed: int = 0,
        lr: float = 1e-3, attn_shard: str = "explicit", device=None,
        timeout: float = 900.0) -> list[float]:
    """The demo: data * model ranks (on the CPU under gloo, default 2 x 2;
    on the cards under NCCL, one rank per visible card, default model =
    min(2, cards)), `steps` sharded steps; returns rank 0's losses and
    raises unless the loss fell."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to run the demo "
                           "under gloo on the CPU")
    if cpu:
        data, model = data or 2, model or 2
    else:
        n = torch.cuda.device_count()
        model = model or min(2, n)
        data = data or n // model
        if data * model > n:
            raise ValueError(f"a {data}x{model} mesh needs {data * model} cards; "
                             f"{n} are visible (NCCL takes one rank per card)")
    kw = dict(steps=steps, batch=batch, seq=seq, data=data, model=model, seed=seed, lr=lr,
              attn_shard=attn_shard)
    rank_device = "cpu" if cpu else None
    world = data * model
    if world == 1 and not dist.is_initialized():
        init_world(0, 1, "gloo" if cpu else "nccl")
        try:
            losses = _demo_rank(0, arch, rank_device, kw)
        finally:
            dist.destroy_process_group()
    else:
        losses = spawn(_demo_rank, world, (arch, rank_device, kw),
                       backend="gloo" if cpu else "nccl", timeout=timeout)[0]
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall: {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-3b-a800m-smoke")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--data", type=int, default=None)
    ap.add_argument("--model", type=int, default=None)
    ap.add_argument("--attn-shard", default="explicit", choices=("auto", "explicit"))
    ap.add_argument("--device", default=None, help="'cpu' for gloo; default the cards (NCCL)")
    a = ap.parse_args(argv)
    run(a.arch, steps=a.steps, batch=a.batch, seq=a.seq, data=a.data, model=a.model,
        attn_shard=a.attn_shard, device=a.device)


if __name__ == "__main__":
    main()
