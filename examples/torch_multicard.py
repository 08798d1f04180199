"""The port across the cards of one host: the simulation's `shard=` and
the meshed model, each held against its one-card run.

  python3 examples/torch_multicard.py                 # every visible card
  PYTHONPATH=src python examples/torch_multicard.py --device cpu --rounds 3 \\
      --arch granite-moe-3b-a800m-smoke --layers 0 \\
      --rwkv-arch rwkv6-7b-smoke --rwkv-layers 0       # rehearsal on the CPU

Part 1, the simulation: the 16-cell `run_many` scan group of
`chip_smoke.py` (mnist, N 20, K 4, 500 samples; the paper's four DS
policies x seeds 0-3) and Γ at 32 768 devices x 4 sub-channels, each
unsharded on the first card (`shard=False`) and sharded over every visible
card (`shard=True`, a block per card), in turns (unsharded, sharded,
sharded, unsharded): every field of every sharded run bitwise the
unsharded run's, K1 launched once per card; the wall time of each run.

Part 2, the meshed model: one process per card (NCCL; gloo on the CPU),
granite-moe-3b-a800m at full width and `--layers` layers, batch 8.  On
every rank, for each entry of `MESHES`, the meshed gradient
(`train_step.make_grad_fn` on the rank's blocks and data shard,
attn_shard="explicit": the expert-parallel MoE, `sharded_causal_attention`)
against its reference from the same weights on the same batch, computed
on that rank's card and cut to the rank's blocks: the unsharded whole
batch, or where each data shard's MoE drops its own copies the unsharded
model on each data shard (`multidevice_demo.shardwise_grads`).  On
float32 copies of the weights: the loss and the gradient norm within 1e-5
relative and every gradient leaf within 1e-4 of its norm.  Against the
whole-batch reference also one meshed AdamW step (lr 1e-3,
`multidevice_demo.run_rank`) against the unsharded donated step: its
loss, and the rank's blocks of the parameters within 2 lr + 2 bf16 ulp
(`excess`: a check of the sharded update, which any gradient passes).  In
bf16 the same numbers reported; then `--steps` meshed steps from the seed
on (data=2, model=cards/2), each step's wall time beside the unsharded
step's.

Part 3, RWKV-6 head-parallel: one process per card, rwkv6-7b (`--rwkv-arch`)
at full width and `--rwkv-layers` layers (0: all) through K5 (`rwkv_wkv_impl="pallas"`), float32
copies of the weights, on (data=1, model=cards): a meshed prefill of
4 x 256 tokens and 4 greedy decode steps (each rank's heads, 64 / cards,
through K5 in the model; the WKV state held as the rank's head block)
against the unsharded prefill and steps on that rank's card: every
step's logits within 1e-4 of their scale and the tokens equal, and K5
launched once per layer per prefill and step on the meshed path (its
counter set to 0 just before the path, read just after).

`--parts` picks the parts (default all three).  On the CPU (`--device cpu`)
the cards are 4 emulated devices
(`launch.mesh.emulate_devices`) and 4 gloo processes.  Every line names
the card and its power limit; any failure exits non-zero.
"""
import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import PAPER_BASELINE_DS, RoundPolicy, WirelessConfig  # noqa: E402
from repro_torch.core.monotonic_torch import solve_pairs_fused  # noqa: E402
from repro_torch.fl import SimConfig, run_many  # noqa: E402
from repro_torch.kernels.polyblock_fused.ops import polyblock_solve_fused  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import wkv6  # noqa: E402
from repro_torch.launch.mesh import emulate_devices, local_devices, smoke_mesh  # noqa: E402
from repro_torch.launch.multidevice_demo import (demo_ctx, fl_batches, leaf_gaps,  # noqa: E402
                                                 run_rank, shard_rows, shardwise_grads,
                                                 spawn)
from repro_torch.models.transformer import init_params, param_specs  # noqa: E402
from repro_torch.sharding.params import shard_tree  # noqa: E402
from repro_torch.sharding.partition import leaves_with_path  # noqa: E402
from repro_torch.train.optimizer import adamw  # noqa: E402
from repro_torch.train.serve_step import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.train.train_step import make_grad_fn, make_train_step  # noqa: E402
from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten  # noqa: E402

LOSS_RTOL, GNORM_RTOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4
LR = 1e-3
RWKV_SERVE = dict(batch=4, prompt=256, new=4, logit_rtol=1e-4)


def excess(got: torch.Tensor, want: torch.Tensor) -> float:
    """The most |got - want| exceeds 2 lr plus 2 bf16 ulp of the larger
    magnitude, elementwise: AdamW's first step moves a parameter by about
    +-lr, so a gradient whose sign differs between two summation orders
    moves it 2 lr, and the bf16 sums round once more each.  <= 0 holds."""
    a, b = got.float(), want.float()
    mag = torch.clamp(torch.maximum(a.abs(), b.abs()), min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((a - b).abs() - 2 * LR - 2 * ulp).max())


def card() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def sync(device: str) -> None:
    if device != "cpu":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def same_bits(a, b) -> list[str]:
    """The fields of two histories but the wall times that differ in any bit."""
    diff = []
    for f in dataclasses.fields(a):
        if f.name in ("wall_s", "plan_wall_s"):
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, dict):
            same = x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        else:
            same = np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y
        if not same:
            diff.append(f.name)
    return diff


def simulation_part(device: str, rounds: int, n_cards: int, label: str) -> dict:
    cfgs = [SimConfig(dataset="mnist", n_devices=20, n_subchannels=4, n_samples=500,
                      rounds=rounds, eval_every=5, seed=s, policy=RoundPolicy(ds=d))
            for d in PAPER_BASELINE_DS for s in range(4)]
    rng = np.random.default_rng(21)
    h2 = rng.exponential(size=(4, 32768)) * 3
    beta = np.broadcast_to(rng.integers(5, 60, 32768).astype(np.float64), h2.shape)
    dev0 = "cpu" if device == "cpu" else "cuda:0"
    walls = {part: {"unsharded": [], "sharded": []} for part in ("group", "gamma")}
    ref = {}
    for turn in ("unsharded", "sharded", "sharded", "unsharded"):
        shard = turn == "sharded"
        polyblock_solve_fused.launches = 0
        sync(device)
        t0 = time.perf_counter()
        ra = solve_pairs_fused(beta, h2, WirelessConfig(), device=dev0, shard=shard)
        sync(device)
        walls["gamma"][turn].append(time.perf_counter() - t0)
        k1 = polyblock_solve_fused.launches
        t0 = time.perf_counter()
        hists = run_many(cfgs, engine="scan", device=dev0, shard=shard)
        sync(device)
        walls["group"][turn].append(time.perf_counter() - t0)
        if turn not in ref:
            ref[turn] = (ra, hists, k1)
            continue
        ra0, hists0, _ = ref[turn]
        assert all(np.array_equal(getattr(ra, f), getattr(ra0, f), equal_nan=True)
                   for f in ("tau", "p", "time_s", "iterations")), f"Γ {turn} not repeatable"
    (ra_u, h_u, k1_u), (ra_s, h_s, k1_s) = ref["unsharded"], ref["sharded"]
    gamma_diff = [f for f in ("feasible", "iterations", "tau", "p", "time_s", "energy_j")
                  if not np.array_equal(getattr(ra_s, f), getattr(ra_u, f), equal_nan=True)]
    group_diff = [f"{i}: {d}" for i, (a, b) in enumerate(zip(h_s, h_u)) if (d := same_bits(a, b))]
    k1_want = n_cards if device != "cpu" else 0
    print(f"Γ 32768x4 ({int(ra_u.feasible.sum())} feasible rows) over {n_cards} devices: "
          f"bitwise equal to unsharded in every field: {not gamma_diff}"
          + (f" (differ: {gamma_diff})" if gamma_diff else "")
          + f"; K1 launches sharded={k1_s} unsharded={k1_u}; wall s unsharded "
          + " ".join(f"{w:.4f}" for w in walls["gamma"]["unsharded"]) + ", sharded "
          + " ".join(f"{w:.4f}" for w in walls["gamma"]["sharded"]) + f" [{label}]", flush=True)
    print(f"run_many 16-cell scan group, {rounds} rounds, over {n_cards} devices: every cell "
          f"bitwise its unsharded group run: {not group_diff}"
          + (f" (differ: {group_diff})" if group_diff else "") + "; wall s unsharded "
          + " ".join(f"{w:.3f}" for w in walls["group"]["unsharded"]) + ", sharded "
          + " ".join(f"{w:.3f}" for w in walls["group"]["sharded"]) + f" [{label}]", flush=True)
    if gamma_diff or group_diff or (device != "cpu" and (k1_s, k1_u) != (k1_want, 1)):
        raise AssertionError("the sharded simulation differs from the unsharded one")
    return dict(walls=walls, k1=[k1_u, k1_s])


def _reference(cfg, full, batch: int, seq: int, steps: int, dev):
    """The unsharded donated step on one card from `full` on the demo's
    first batch: (its loss, the parameters after it, the wall seconds of
    it and of `steps` more)."""
    ex = _first_batch(cfg, batch, seq, dev)
    opt = adamw(LR)
    params = tree_map(torch.clone, full)
    state = opt.init(params)
    step = make_train_step(cfg, opt, remat=False, donate=True)
    walls = []
    for i in range(1 + steps):
        t0 = time.perf_counter()
        params, state, m = step(params, state, ex)
        loss = float(m["loss"])
        walls.append(time.perf_counter() - t0)
        if i == 0:
            out = (loss, tree_map(torch.clone, params))
    return out + (walls,)


def _first_batch(cfg, batch: int, seq: int, dev) -> dict:
    return {k: torch.as_tensor(v, device=dev)
            for k, v in next(fl_batches(cfg, batch, seq, 0))[0].items()}


def _grad_check(cfg, full, batch: int, seq: int, data: int, model: int, ref: str,
                dev) -> dict:
    """The meshed gradient (`make_grad_fn` on this rank's blocks and data
    shard) against its reference from the same weights on the same batch,
    cut to this rank's blocks: ref "whole", the unsharded gradient of the
    whole batch; ref "shards", `shardwise_grads` (each data shard's
    capacity its own; the load-balance term off on both sides)."""
    if ref == "shards":
        cfg = dataclasses.replace(cfg, router_aux_coef=0.0)
    ex = _first_batch(cfg, batch, seq, dev)
    ctx = demo_ctx(data, model, batch, seq, "explicit", dev.type)
    specs = param_specs(cfg, ctx.mesh, model)
    got, m = make_grad_fn(cfg, remat=False, ctx=ctx)(
        shard_tree(full, specs, ctx.mesh), {k: shard_rows(v, ctx) for k, v in ex.items()})
    whole, rm = make_grad_fn(cfg, remat=False)(full, ex)
    if ref == "shards":
        ref_loss, want = shardwise_grads(cfg, full, ex, data)
        ref_gnorm = float(torch.sqrt(sum(torch.sum(torch.square(g)) for g in want)))
        # How far the whole batch's gradient is from it: the drops' share.
        whole_gap = max(leaf_gaps(whole, want))
    else:
        want, ref_loss, ref_gnorm = whole, float(rm["loss"]), float(rm["grad_norm"])
        whole_gap = 0.0
    del whole
    want = tree_leaves(shard_tree(tree_unflatten(full, want), specs, ctx.mesh))
    gaps = leaf_gaps(got, want)
    worst = max(range(len(gaps)), key=gaps.__getitem__)
    return dict(loss=float(m["loss"]), ref_loss=ref_loss, gnorm=float(m["grad_norm"]),
                ref_gnorm=ref_gnorm, grad_gap=gaps[worst], whole_gap=whole_gap,
                worst_leaf=str(leaves_with_path(full)[worst][0]))


def _model_rank(rank, arch, layers, batch, seq, steps, n, device):
    """On this rank, for each entry of MESHES: the meshed gradient against
    its reference and, against the whole-batch reference, one meshed step
    against the unsharded donated step from the same weights on the same
    batch; then `steps` meshed steps on (2, n / 2) in bf16."""
    torch.set_num_threads(1)
    dev = torch.device(device if device == "cpu" else f"cuda:{rank}")
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    # One draw for every mesh: experts padded for the widest model axis,
    # which pads them for its halves too (granite's 40 experts: no padding).
    weights = {"bf16": init_params(cfg, torch.Generator(dev).manual_seed(0), ep_size=n)}
    weights["f32"] = tree_map(lambda t: t.float(), weights["bf16"])
    checks, ref_s = [], None
    for data, model_div, seq_i, dtype, ref, held in MESHES:
        model, seq_i = n // model_div, seq_i or seq
        check = dict(data=data, model=model, seq=seq_i, dtype=dtype, ref=ref, held=held,
                     **_grad_check(cfg, weights[dtype], batch, seq_i, data, model, ref, dev))
        if ref == "whole":
            timed = steps if (seq_i, dtype) == (seq, "bf16") else 0
            ref_loss, ref_one, walls = _reference(cfg, weights[dtype], batch, seq_i, timed, dev)
            ref_s = walls if timed else ref_s
            one = run_rank(cfg, steps=1, batch=batch, seq=seq_i, data=data, model=model,
                           lr=LR, params=tree_map(torch.clone, weights[dtype]), device=dev,
                           log=False)
            mesh = smoke_mesh(data, model, dev.type)
            want = shard_tree(ref_one, param_specs(cfg, mesh, model), mesh)
            pairs = list(zip(tree_leaves(one["params"]), tree_leaves(want)))
            check.update(step_loss=one["losses"][0], step_ref_loss=ref_loss,
                         max_diff=max(float((a.float() - b.float()).abs().max())
                                      for a, b in pairs),
                         excess=max(excess(a, b) for a, b in pairs))
            del one, want, pairs, ref_one
        checks.append(check)
    del weights
    demo = run_rank(cfg, steps=steps, batch=batch, seq=seq, data=2, model=n // 2, lr=LR,
                    device=dev, log=False)
    return {"checks": checks, "mesh_step_s": demo["step_s"], "losses": demo["losses"],
            "ref_step_s": ref_s, "n_params": demo["n_params"],
            "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                         if dev.type == "cuda" else None)}


# (data, n / model, seq (0: --seq), weights, reference, held to it).  In
# float32 the meshed model is its reference up to summation order: every
# card on the model axis at the demo's shape; half the cards on each axis
# at seq 4, where 8 x 4 tokens keep the MoE dropless both whole and per
# data shard, so the whole batch is the reference; and half on each axis
# at the demo's shape, where each data shard's capacity is its own (the
# JAX package's rule) and drops other copies than the whole batch's
# would, so the reference is `shardwise_grads`.  In bf16, reported only:
# the expert combine sums each rank's experts before the all-reduce, one
# rounding order of top-8 outputs against another.
MESHES = ((1, 1, 0, "f32", "whole", True), (2, 2, 4, "f32", "whole", True),
          (2, 2, 0, "f32", "shards", True), (1, 1, 0, "bf16", "whole", False),
          (2, 2, 0, "bf16", "shards", False))


def model_part(args, n_cards: int, label: str) -> dict:
    outs = spawn(_model_rank, n_cards, (args.arch, args.layers, 8, args.seq, args.steps,
                                        n_cards, args.device or "cuda"),
                 backend="gloo" if args.device == "cpu" else "nccl", timeout=args.timeout)
    o = outs[0]
    checks, failed = [], []
    for i, c in enumerate(o["checks"]):
        rows = [r["checks"][i] for r in outs]
        worst = dict(
            loss_rel=max(abs(r["loss"] - r["ref_loss"]) / abs(r["ref_loss"]) for r in rows),
            gnorm_rel=max(abs(r["gnorm"] - r["ref_gnorm"]) / r["ref_gnorm"] for r in rows),
            grad_gap=max(r["grad_gap"] for r in rows))
        at = max(rows, key=lambda r: r["grad_gap"])["worst_leaf"]
        text = (f"meshed model {args.arch} ({args.layers or 'all'} layers, params="
                f"{o['n_params']}, {c['dtype']} weights) on a ({c['data']}, {c['model']}) "
                f"mesh of {n_cards} ranks, batch 8 x seq {c['seq']}, against the "
                + ("unsharded whole batch" if c["ref"] == "whole" else
                   "unsharded model on each data shard (shardwise_grads, aux term off)")
                + f" on each rank's card: loss {c['loss']:.6f} vs {c['ref_loss']:.6f}; worst "
                f"over ranks: loss rel {worst['loss_rel']:.3e}, grad norm rel "
                f"{worst['gnorm_rel']:.3e}, gradient leaf ||g - g_ref|| / ||g_ref|| "
                f"{worst['grad_gap']:.3e} at {at}")
        if c["ref"] == "shards":
            text += (f"; the whole batch's gradient is {max(r['whole_gap'] for r in rows):.3e}"
                     " from this reference (the copies each shard drops)")
        if c["held"]:
            text += f" (limits {LOSS_RTOL:g}, {GNORM_RTOL:g}, {GRAD_RTOL:g})"
            failed += [k for k, lim in (("loss_rel", LOSS_RTOL), ("gnorm_rel", GNORM_RTOL),
                                        ("grad_gap", GRAD_RTOL)) if worst[k] > lim]
        if c["ref"] == "whole":
            worst.update(step_loss_rel=max(abs(r["step_loss"] - r["step_ref_loss"])
                                           / abs(r["step_ref_loss"]) for r in rows),
                         worst_diff=max(r["max_diff"] for r in rows),
                         excess=max(r["excess"] for r in rows))
            text += (f"; one AdamW step (lr {LR}) vs the unsharded donated step: loss rel "
                     f"{worst['step_loss_rel']:.3e}, blocks' max |diff| "
                     f"{worst['worst_diff']:.3e}, beyond 2 lr + 2 bf16 ulp by "
                     f"{worst['excess']:.3e}")
            if c["held"]:
                text += f" (limits {LOSS_RTOL:g} and 0)"
                failed += [k for k, lim in (("step_loss_rel", LOSS_RTOL), ("excess", 0.0))
                           if worst[k] > lim]
        print(text + ("" if c["held"] else " (reported)") + f" [{label}]", flush=True)
        checks.append(dict(c, **worst))
    print(f"  {args.steps} meshed steps from the seed on (2, {n_cards // 2}), bf16: losses "
          + " ".join(f"{x:.4f}" for x in o["losses"]) + "; wall s per step (rank 0) "
          + " ".join(f"{x:.4f}" for x in o["mesh_step_s"]) + "; the unsharded step on one "
          "card " + " ".join(f"{x:.4f}" for x in o["ref_step_s"])
          + ("; max_memory_allocated per card "
             + " ".join(f"{x['peak_gib']:.2f}" for x in outs) + " GiB"
             if o["peak_gib"] is not None else "") + f" [{label}]", flush=True)
    if failed:
        raise AssertionError(f"a meshed step differs from its reference beyond the limits: "
                             f"{failed}")
    if not all(np.isfinite(r["losses"]).all() for r in outs):
        raise AssertionError("a meshed loss is not finite")
    return dict(checks=checks, mesh_step_s=o["mesh_step_s"], ref_step_s=o["ref_step_s"],
                losses=o["losses"])


def _rwkv_rank(rank, arch, layers, n, device):
    """On this rank: rwkv6-7b's meshed prefill and greedy steps on (1, n)
    against the unsharded ones on the rank's device, and K5's launches on
    the meshed path."""
    torch.set_num_threads(1)
    dev = torch.device(device if device == "cpu" else f"cuda:{rank}")
    cfg = dataclasses.replace(get_config(arch), rwkv_wkv_impl="pallas")
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params = tree_map(lambda t: t.float(), init_params(cfg, torch.Generator(dev).manual_seed(0)))
    b, prompt, new = RWKV_SERVE["batch"], RWKV_SERVE["prompt"], RWKV_SERVE["new"]
    tokens = torch.randint(0, cfg.vocab, (b, prompt), device=dev,
                           generator=torch.Generator(dev).manual_seed(7))
    ctx = demo_ctx(1, n, b, prompt, "explicit", dev.type)
    blocks = shard_tree(params, param_specs(cfg, ctx.mesh, n), ctx.mesh)

    def serve(weights, step_ctx) -> list:
        prefill = make_prefill_step(cfg, cache_headroom=new, ctx=step_ctx)
        step = make_serve_step(cfg, ctx=step_ctx)
        with torch.no_grad():
            logits, cache = prefill(weights, {"tokens": tokens})
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            out = [(tok, logits[:, -1])]
            for i in range(new):
                tok, step_logits, cache = step(
                    weights, {"token": tok, "pos": torch.tensor(prompt + i, device=dev)}, cache)
                out.append((tok, step_logits.reshape(b, -1)))
        sync(device)
        return out

    wkv6.launches = 0
    meshed = serve(blocks, ctx)
    launches = wkv6.launches
    plain = serve(params, None)
    errs = [float((lm - lp).abs().max() / lp.abs().max())
            for (_, lm), (_, lp) in zip(meshed, plain)]
    same = all(torch.equal(tm, tp) for (tm, _), (tp, _) in zip(meshed, plain))
    return dict(errs=errs, tokens_equal=same, launches=launches,
                heads=cfg.n_rwkv_heads // n)


def rwkv_part(args, n_cards: int, label: str) -> dict:
    outs = spawn(_rwkv_rank, n_cards, (args.rwkv_arch, args.rwkv_layers, n_cards,
                                       args.device or "cuda"),
                 backend="gloo" if args.device == "cpu" else "nccl", timeout=args.timeout)
    layers = args.rwkv_layers or get_config(args.rwkv_arch).n_layers
    want = layers * (1 + RWKV_SERVE["new"]) if args.device != "cpu" else 0
    worst = max(max(o["errs"]) for o in outs)
    ok = (worst <= RWKV_SERVE["logit_rtol"] and all(o["tokens_equal"] for o in outs)
          and all(o["launches"] == want for o in outs))
    print(f"{args.rwkv_arch} ({layers} layers, float32 weights, K5) head-parallel "
          f"on a (1, {n_cards}) mesh, {outs[0]['heads']} heads a rank: prefill "
          f"{RWKV_SERVE['batch']} x {RWKV_SERVE['prompt']} + {RWKV_SERVE['new']} greedy steps "
          f"against the unsharded model on each rank's card: worst logits |diff| / scale "
          f"{worst:.3e} (limit {RWKV_SERVE['logit_rtol']:g}), tokens equal on every rank "
          f"{all(o['tokens_equal'] for o in outs)}; K5 launches on the meshed path per rank "
          + " ".join(str(o["launches"]) for o in outs) + f" (expected {want}) [{label}]",
          flush=True)
    if not ok:
        raise AssertionError("the head-parallel rwkv6-7b differs from the unsharded model")
    return dict(worst_logit_err=worst, launches=[o["launches"] for o in outs])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="'cpu' to rehearse; default the cards")
    ap.add_argument("--arch", default="granite-moe-3b-a800m")
    ap.add_argument("--layers", type=int, default=16, help="0 keeps the config's depth")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--rwkv-arch", default="rwkv6-7b")
    ap.add_argument("--rwkv-layers", type=int, default=2)
    ap.add_argument("--parts", default="simulation,model,rwkv",
                    help="comma-separated: simulation, model, rwkv")
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))
    label = card()
    t_all = time.perf_counter()
    sim = mod = rwkv = None
    if args.device == "cpu":
        n_cards = 4
        if "simulation" in parts:
            with emulate_devices(n_cards):
                sim = simulation_part("cpu", args.rounds, n_cards, label)
    else:
        n_cards = len(local_devices("cuda"))
        if n_cards < 2 or n_cards % 2:
            sys.exit(f"torch_multicard: needs an even number of cards >= 2, sees {n_cards}")
        print(f"{label} x{n_cards}; torch {torch.__version__} cuda {torch.version.cuda}",
              flush=True)
        if "simulation" in parts:
            sim = simulation_part("cuda", args.rounds, n_cards, label)
    t_sim = time.perf_counter()
    if "model" in parts:
        mod = model_part(args, n_cards, label)
    t_mod = time.perf_counter()
    if "rwkv" in parts:
        rwkv = rwkv_part(args, n_cards, label)
    print(f"wall_s: simulation {t_sim - t_all:.1f}, model {t_mod - t_sim:.1f}, rwkv "
          f"{time.perf_counter() - t_mod:.1f} [{label}]")
    print(json.dumps({"cards": n_cards, "card": label, "simulation": sim, "model": mod,
                      "rwkv": rwkv}))


if __name__ == "__main__":
    main()
