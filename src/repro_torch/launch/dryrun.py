"""Dry run of the model zoo on the meta device (the PyTorch port's
counterpart of the JAX package's `launch/dryrun.py`): for every
(architecture x input shape) it proves the step is coherent on the
production mesh and prices it, with no card, as the JAX dry run does with
no TPU.

The production mesh (the default): torch's fake process group as rank 0
of 256 ranks, (data=16, model=16), or with --multi-pod of 512, (pod=2,
data=16, model=16) (`launch.mesh.fake_mesh`; every collective is
dispatched and returns at once).  For each combination the dry run:
  1. builds rank 0's step on meta tensors (`build_step` with a meshed
     `ShardCtx`, as `src/repro/launch/dryrun.py::build_step` lowers its
     step): the parameters as this rank's blocks of
     `param_shapes(cfg, ep_size=model)` (`sharding.params.shard_tree`,
     each block its own storage), the optimizer's state of those blocks in
     `opt_state_shardings`' layout (`train_step.mesh_optimizer`), the batch
     as this rank's shard by `batch_shardings` and the decode cache as its
     block by `cache_shardings`; `make_train_step(ctx=)` with
     `make_optimizer(cfg.optimizer)` (Adafactor for deepseek-v3, jamba and
     qwen1.5-110b, as in the JAX dry run) for train shapes, donated (the
     JAX dry run's `donate_argnums=(0, 1)`; Adafactor's moments written in
     place, so left out of temp as donated buffers are),
     `make_prefill_step(ctx=)` for prefill, `make_serve_step(ctx=)` for
     decode;
  2. sums the arguments' bytes on this device (`argument_size_in_bytes`;
     each storage once, the optimizer's moments as distinct tensors, as
     after the first step);
  3. runs the step once on those meta tensors (`launch/step_analysis.py`):
     the FLOPs this device computes, counted op by op (`counted_flops`, in
     place of the JAX result's `hlo_flops_static`), the peak bytes of live
     intermediates (`temp_size_in_bytes`) and every collective with the
     bytes of its result on this device (`collectives`, the JAX result's
     keys; with --detail the 15 largest by call site); a config whose
     layers loop over tokens in Python (Mamba, the "ref" WKV) is counted at
     1 and 2 repeats of its stage and scaled to its depth
     (`step_analysis.depth_scaled`);
  4. prices it with the analytic roofline of the mesh's H100s
     (`analytic.analytic_cost(cfg, shape, HW(chips=devices),
     collective_bytes_per_dev=total)`), and reports whether arguments plus
     temp fit one card's 80 GiB (`fits`; a combination that does not fit
     is reported, not failed, as in the JAX dry run).
With --attn-shard explicit, full-sequence attention is head- or
sequence-parallel over `model` (`models.attention.sharded_causal_attention`).

--one-card keeps the dry run of one card (no process group: the model's
single-device step, `devices` 1, `mesh` "1", every collective 0), which
the card's own phase holds against memory measured on the card; the JAX
dry run has no such mode.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
      [--attn-shard explicit] [--detail] [--json out.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch jamba-v0.1-52b \\
      --shape decode_32k --override n_layers=16 --one-card
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import sys
import time

import torch
from torch.utils._pytree import tree_map

from ..configs import ARCHS, INPUT_SHAPES, get_config
from ..models.transformer import param_shapes, param_specs
from ..sharding.ctx import ShardCtx, meshed
from ..sharding.params import shard_tree
from ..sharding.partition import batch_shardings, cache_shardings
from ..train.optimizer import make_optimizer
from ..train.train_step import (make_prefill_step, make_serve_step, make_train_step,
                                mesh_optimizer)
from .analytic import H100, HW, analytic_cost, model_flops
from .mesh import dp_axes_of, fake_mesh, mesh_shape
from .specs import cache_specs, decode_input_specs, input_specs
from .step_analysis import (analyze_step, collective_stats, depth_scaled, loops_over_tokens,
                            tree_nbytes)

__all__ = ["steady_opt_state", "build_step", "analyze", "mesh_ctx", "dryrun_one", "main",
           "CARD_BYTES"]

CARD_BYTES = 80 * 2**30        # one H100 SXM's HBM3


def steady_opt_state(opt, params):
    """opt.init(params) with every leaf its own tensor, as a step leaves the
    state: adam's and adamw's init hand one zero tree to both moments,
    which the first update replaces by two."""
    return tree_map(lambda t: torch.empty_like(t) if isinstance(t, torch.Tensor) else t,
                    opt.init(params))


def mesh_ctx(mesh, shape, attn_shard: str = "auto") -> ShardCtx:
    """The dry run's sharding context on `mesh` for an input `shape`: the
    batch on the data axes where the rules shard it (long_500k's batch of
    one stays whole)."""
    dp = dp_axes_of(mesh)
    spec = batch_shardings({"tokens": torch.empty(shape.global_batch, 1, device="meta")},
                           mesh, dp)[("tokens",)]
    return ShardCtx(mesh=mesh, dp_axes=dp, attn_shard=attn_shard,
                    batch_sharded=spec[0] is not None)


def build_step(cfg, shape, *, ctx: ShardCtx | None = None, opt=None, remat: bool = True,
               donate: bool | None = None, cache_headroom: int = 0):
    """Returns (step fn, its arguments as meta tensors).  A train step takes
    `opt` (default make_optimizer(cfg.optimizer, 1e-4)) with its state as
    in the steady state (`steady_opt_state`), `remat` and `donate` (default:
    donated wherever `opt` has an in-place update, every optimizer but a
    chain, as the JAX dry run donates); a
    prefill step keeps `cache_headroom` free decode slots, as
    `serve_loop`'s does.  With a meshed `ctx` (the mirror of the JAX dry
    run's `build_step`, ep_size = the `model` axis) the arguments are this
    rank's: parameter blocks, the optimizer state of those blocks, the
    batch shard and the cache block (module docstring)."""
    mesh = ctx.mesh if meshed(ctx) else None
    params = param_shapes(cfg, ep_size=ctx.ep_size if mesh is not None else 1)
    if mesh is not None:
        params = shard_tree(params, param_specs(cfg, mesh, ctx.ep_size), mesh)

    def local(tree, rule):
        """This rank's blocks of `tree` under `rule` (`batch_shardings` or
        `cache_shardings`), or `tree` off a mesh."""
        return tree if mesh is None else shard_tree(tree, rule(tree, mesh, ctx.dp_axes), mesh)

    if shape.kind == "train":
        opt = opt or make_optimizer(cfg.optimizer, 1e-4)
        if donate is None:
            donate = opt.donate is not None
        step = make_train_step(cfg, opt, remat=remat, donate=donate, ctx=ctx)
        state = steady_opt_state(mesh_optimizer(cfg, opt, ctx), params)
        return step, (params, state, local(input_specs(cfg, shape), batch_shardings))
    if shape.kind == "prefill":
        return (make_prefill_step(cfg, cache_headroom=cache_headroom, ctx=ctx),
                (params, local(input_specs(cfg, shape), batch_shardings)))
    return make_serve_step(cfg, ctx=ctx), (params,
                                           local(decode_input_specs(cfg, shape), batch_shardings),
                                           local(cache_specs(cfg, shape), cache_shardings))


def analyze(cfg, shape, **build_kw) -> dict:
    """`step_analysis.analyze_step` of the step (`build_step(cfg, shape,
    **build_kw)`), depth-scaled where the config's layers loop over
    tokens."""
    def run(c):
        fn, args = build_step(c, shape, **build_kw)
        return analyze_step(fn, *args)

    if loops_over_tokens(cfg, shape.kind):
        return depth_scaled(cfg, run)
    return {**run(cfg), "depth_scaled": 0}


def _gib(n: float) -> str:
    return f"{n / 2**30:.2f} GiB"


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               mesh: str = "production", attn_shard: str = "auto", detail: bool = False,
               verbose: bool = True, overrides: dict | None = None) -> dict:
    """One combination's result, with the JAX dry run's keys (per device):
    mesh "16x16" / "2x16x16" and devices 256 / 512 on the production mesh
    (mesh="production", `multi_pod`), "1" and 1 on one card (mesh="one");
    argument, temp and output bytes, collectives, roofline; beside them
    counted_flops (this device's), model_flops (the whole step's),
    depth_scaled, fits and the build and run wall seconds."""
    if mesh not in ("production", "one"):
        raise ValueError(f"dryrun_one: mesh={mesh!r}; choose 'production' or 'one'")
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    cfg = cfg.for_shape(shape)  # long_500k -> sliding-window variant
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    if mesh == "one":
        if multi_pod or attn_shard != "auto":
            raise ValueError("dryrun_one: multi_pod and attn_shard take the production mesh")
        return _measure(arch, shape_name, cfg, shape, None, detail, verbose)
    with fake_mesh(multi_pod=multi_pod) as dmesh:
        return _measure(arch, shape_name, cfg, shape, mesh_ctx(dmesh, shape, attn_shard),
                        detail, verbose)


def _measure(arch, shape_name, cfg, shape, ctx, detail: bool, verbose: bool) -> dict:
    t0 = time.perf_counter()
    _, args = build_step(cfg, shape, ctx=ctx)
    arg_bytes = tree_nbytes(args)
    cache_bytes = tree_nbytes(args[2]) if shape.kind == "decode" else 0
    del args
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    step = analyze(cfg, shape, ctx=ctx)
    t_run = time.perf_counter() - t0

    if ctx is None:
        devices, mesh_name = 1, "1"
    else:
        sizes = mesh_shape(ctx.mesh)
        devices, mesh_name = 1, "x".join(str(n) for n in sizes.values())
        for n in sizes.values():
            devices *= n
    coll = collective_stats(step["collective_calls"], detail=detail,
                            raw=step["raw_collective_calls"])
    roof = analytic_cost(cfg, shape, HW(chips=devices) if devices > 1 else H100,
                         collective_bytes_per_dev=coll["total"])
    mf = model_flops(cfg, shape)
    res = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "devices": devices,
        "attn_shard": ctx.attn_shard if ctx is not None else "auto",
        "counted_flops": float(step["flops"]),
        "counted_flops_by_op": step["flops_by_op"],
        "model_flops": mf["train_total"] if shape.kind == "train" else mf["forward"],
        "depth_scaled": step["depth_scaled"],
        "collectives": coll,
        "roofline": roof,
        "build_s": round(t_build, 2),
        "run_s": round(t_run, 2),
        "argument_size_in_bytes": int(arg_bytes),
        "temp_size_in_bytes": int(step["temp_size_in_bytes"]),
        "output_size_in_bytes": int(step["output_size_in_bytes"]),
        "cache_size_in_bytes": int(cache_bytes),
    }
    res["fits"] = res["argument_size_in_bytes"] + res["temp_size_in_bytes"] <= CARD_BYTES
    if verbose:
        _report(res, detail)
    return res


def _report(res: dict, detail: bool) -> None:
    coll, roof = res["collectives"], res["roofline"]
    n = res["devices"]
    print(f"== {res['arch']} x {res['shape']} on {res['mesh']} ({n} device{'s' * (n > 1)}, "
          f"meta{', attn_shard=' + res['attn_shard'] if n > 1 else ''}) ==")
    print(f"   build {res['build_s']:.2f}s  run {res['run_s']:.2f}s"
          + (f" (depth-scaled from 1 and 2 of {res['depth_scaled']} repeats)"
             if res["depth_scaled"] else ""))
    total = res["argument_size_in_bytes"] + res["temp_size_in_bytes"]
    print(f"   per-device args {_gib(res['argument_size_in_bytes'])}, "
          f"temp {_gib(res['temp_size_in_bytes'])}"
          + (f" (cache {_gib(res['cache_size_in_bytes'])})" if res["cache_size_in_bytes"]
             else "")
          + f"; args + temp {_gib(total)} of {_gib(CARD_BYTES)}: fits={res['fits']}")
    print(f"   counted flops/dev={res['counted_flops']:.3e} "
          f"(analytic, whole step {res['model_flops']:.3e}, ratio x devices "
          f"{res['counted_flops'] * n / max(res['model_flops'], 1.0):.3f})")
    if n == 1:
        print(f"   collectives/dev: none on one card (total {coll['total']})")
    else:
        by_op = {k: f"{coll[k] / 2**20:.1f}MiB" for k in
                 ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute", "total") if coll[k]}
        print(f"   collectives/dev (depth-scaled): {by_op} count={coll['count']}")
    print(f"   roofline ({n} x H100): compute={roof['compute_s'] * 1e3:.2f}ms "
          f"memory={roof['memory_s'] * 1e3:.2f}ms "
          f"collective={roof['collective_s'] * 1e3:.2f}ms "
          f"-> dominant={roof['dominant']} "
          f"useful={roof['useful_ratio']:.2f}")
    if detail and coll.get("top"):
        print("   top collectives (op, MiB total, xcalls, call site):")
        for op, b, calls, site in coll["top"]:
            print(f"     {op:20s} {b / 2**20:10.1f}  x{calls:<4d} {site[:90]}")


def _literal(v: str):
    """A CLI override value: a Python literal (int, float, bool, None,
    string in quotes), else the string as given."""
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), default=None)
    ap.add_argument("--all", action="store_true", help="all 10 x 4 combos")
    ap.add_argument("--json", default=None, help="write results to this file")
    ap.add_argument("--override", action="append", default=[],
                    help="config override key=value (repeatable), e.g. "
                         "--override mla_absorb=True")
    ap.add_argument("--multi-pod", action="store_true", help="2x16x16 mesh")
    ap.add_argument("--detail", action="store_true",
                    help="print the largest individual collectives")
    ap.add_argument("--attn-shard", choices=("auto", "explicit"), default="auto",
                    help="explicit = shard_map head-/sequence-parallel "
                         "attention (§Perf optimization)")
    ap.add_argument("--one-card", action="store_true",
                    help="the dry run of one card: no mesh, no collective (the port's own "
                         "mode; the JAX dry run has none)")
    args = ap.parse_args(argv)
    if args.one_card and (args.multi_pod or args.detail or args.attn_shard != "auto"):
        ap.error("--one-card takes no mesh: --multi-pod, --detail and --attn-shard are "
                 "the production mesh's")

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        overrides[k] = _literal(v)

    if args.all:
        combos = [(a, s) for a in ARCHS for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("need --all or both --arch and --shape")

    torch.set_num_threads(1)
    results, failures = [], []
    t0 = time.perf_counter()
    for arch, shp in combos:
        try:
            results.append(dryrun_one(arch, shp, multi_pod=args.multi_pod,
                                      mesh="one" if args.one_card else "production",
                                      attn_shard=args.attn_shard, detail=args.detail,
                                      overrides=overrides))
        except Exception as e:  # noqa: BLE001 - report and continue
            print(f"!! FAILED {arch} x {shp}: {type(e).__name__}: {e}")
            failures.append((arch, shp, str(e)))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"results": results, "failures": failures}, f, indent=1)
    print(f"\n{len(results)} passed, {len(failures)} failed "
          f"({time.perf_counter() - t0:.1f}s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
