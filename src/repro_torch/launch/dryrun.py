"""Dry run of the model zoo on one card, on the meta device (the PyTorch
port's counterpart of the JAX package's `launch/dryrun.py`): for every
(architecture x input shape) it proves the step is coherent and prices it
without a card, as the JAX dry run does without a TPU.

For each combination this driver:
  1. builds the step on meta tensors (`build_step`): the parameters from
     `models.transformer.param_shapes`, the inputs and the decode cache
     from `launch/specs.py`, and `make_train_step` with
     `make_optimizer(cfg.optimizer)` (Adafactor for deepseek-v3 and jamba,
     as in the JAX dry run) for train shapes, donated where the optimizer
     updates in place (`make_train_step(donate=True)`, the JAX dry run's
     `donate_argnums=(0, 1)`; Adafactor's step is not donated),
     `make_prefill_step` for prefill, `make_serve_step` for decode;
  2. sums the arguments' bytes (parameters, optimizer state, batch, cache:
     `argument_size_in_bytes`; each storage once, the optimizer's moments
     as distinct tensors, as after the first step);
  3. runs the step once on those meta tensors (`launch/step_analysis.py`):
     the FLOPs counted op by op (`counted_flops`, in place of the JAX
     result's `hlo_flops_static`) and the peak bytes of live
     intermediates (`temp_size_in_bytes`); a config whose layers loop over
     tokens in Python (Mamba, the "ref" WKV) is counted at 1 and 2 repeats
     of its stage and scaled to its depth (`step_analysis.depth_scaled`);
  4. prices it with the analytic roofline of one H100
     (`analytic.analytic_cost(cfg, shape, H100)`).
The mesh is one card: `devices` 1, `mesh` "1", every collective 0.  No
card is needed; meta tensors hold no storage and compute nothing.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--json out.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch jamba-v0.1-52b \\
      --shape decode_32k --override n_layers=16

`--multi-pod`, `--detail` and `--attn-shard` are not taken: the dry run on
the production mesh (a fake process group at 256 and 512 ranks on meta
tensors) is still to come.
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
from ..models.transformer import param_shapes
from ..train.optimizer import make_optimizer
from ..train.train_step import make_prefill_step, make_serve_step, make_train_step
from .analytic import H100, analytic_cost, model_flops
from .specs import cache_specs, decode_input_specs, input_specs
from .step_analysis import (analyze_step, collective_stats, depth_scaled, loops_over_tokens,
                            tree_nbytes)

__all__ = ["steady_opt_state", "build_step", "analyze", "dryrun_one", "main"]


def steady_opt_state(opt, params):
    """opt.init(params) with every leaf its own tensor, as a step leaves the
    state: adam's and adamw's init hand one zero tree to both moments,
    which the first update replaces by two."""
    return tree_map(lambda t: torch.empty_like(t) if isinstance(t, torch.Tensor) else t,
                    opt.init(params))


def build_step(cfg, shape, *, opt=None, remat: bool = True, donate: bool | None = None,
               cache_headroom: int = 0):
    """Returns (step fn, its arguments as meta tensors).  A train step takes
    `opt` (default make_optimizer(cfg.optimizer, 1e-4)) with its state as
    in the steady state (`steady_opt_state`), `remat` and `donate` (default:
    donated where `opt` updates in place, as `train_loop` runs it); a
    prefill step keeps `cache_headroom` free decode slots, as
    `serve_loop`'s does."""
    params = param_shapes(cfg)
    if shape.kind == "train":
        opt = opt or make_optimizer(cfg.optimizer, 1e-4)
        if donate is None:
            donate = opt.donate is not None
        step = make_train_step(cfg, opt, remat=remat, donate=donate)
        return step, (params, steady_opt_state(opt, params), input_specs(cfg, shape))
    if shape.kind == "prefill":
        return (make_prefill_step(cfg, cache_headroom=cache_headroom),
                (params, input_specs(cfg, shape)))
    return make_serve_step(cfg), (params, decode_input_specs(cfg, shape),
                                  cache_specs(cfg, shape))


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


def dryrun_one(arch: str, shape_name: str, *, verbose: bool = True,
               overrides: dict | None = None) -> dict:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    cfg = cfg.for_shape(shape)  # long_500k -> sliding-window variant
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    t0 = time.perf_counter()
    _, args = build_step(cfg, shape)
    arg_bytes = tree_nbytes(args)
    del args
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    step = analyze(cfg, shape)
    t_run = time.perf_counter() - t0

    coll = collective_stats()
    roof = analytic_cost(cfg, shape, H100, collective_bytes_per_dev=coll["total"])
    mf = model_flops(cfg, shape)
    res = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "1",
        "devices": 1,
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
    }
    if verbose:
        print(f"== {arch} x {shape_name} on {res['mesh']} ({res['devices']} device, meta) ==")
        print(f"   build {t_build:.2f}s  run {t_run:.2f}s"
              + (f" (depth-scaled from 1 and 2 of {step['depth_scaled']} repeats)"
                 if step["depth_scaled"] else ""))
        print(f"   per-device args {arg_bytes / 2**30:.2f} GiB, "
              f"temp {res['temp_size_in_bytes'] / 2**30:.2f} GiB")
        print(f"   counted flops={res['counted_flops']:.3e} "
              f"(analytic {res['model_flops']:.3e}, ratio "
              f"{res['counted_flops'] / max(res['model_flops'], 1.0):.3f})")
        print(f"   collectives/dev: none on one card (total {coll['total']})")
        print(f"   roofline (H100): compute={roof['compute_s'] * 1e3:.2f}ms "
              f"memory={roof['memory_s'] * 1e3:.2f}ms "
              f"collective={roof['collective_s'] * 1e3:.2f}ms "
              f"-> dominant={roof['dominant']} "
              f"useful={roof['useful_ratio']:.2f}")
    return res


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
    args = ap.parse_args(argv)

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
            results.append(dryrun_one(arch, shp, overrides=overrides))
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
