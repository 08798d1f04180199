"""Card timings of the meshed model's tensor-parallel path.

  python3 examples/torch_tp_timing.py decode [--src DIR]   # meshed vs unmeshed decode
  python3 examples/torch_tp_timing.py gemm                 # the row-parallel partial product

`decode`: in a world-of-one NCCL group, for granite-moe-3b-a800m (full
width, 16 layers) and rwkv6-7b (full width, 4 layers, K5): the greedy
decode step of the meshed model on a (1, 1) mesh (`make_serve_step(ctx=)`
on the rank's blocks) and of the unmeshed model, from one prefill of
4 x 256 tokens each; after one warm-up pass of each path, `--repeats`
passes of `--steps` steps, the two paths in turns (meshed first, then
unmeshed, each pass timed alone between card syncs).  Prints each pass's
ms/step, each path's median, min and max and the ratio of the medians.
`--src` takes the package from another tree (e.g. an unpacked parent
commit), so two commits are timed by one script on one card.

`gemm`: the row-parallel layers' partial product x @ w with bf16 x and w
at qwen2-7b's widths over 16 model ranks (wo: 224 x 3584, down: 1184 x
3584; 16 384 tokens): the bf16 product (bf16 output), the bf16 product
with a float32 output (`torch.mm(out_dtype=)`, what `comm._mm_f32` runs
on the card) and the float32 product of the widened inputs; median of
CUDA-event times and the two float32 results' largest difference.

Every line names the card and its power limit.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def decode_passes(cfg, params, blocks, ctx, tokens, steps: int, repeats: int) -> dict:
    """{"meshed": [ms/step per pass], "unmeshed": [...]}: one prefill per
    path with room for every pass, one warm-up pass each, then `repeats`
    passes of `steps` greedy steps in turns."""
    import torch
    from repro_torch.train.serve_step import make_prefill_step, make_serve_step

    prompt = tokens.shape[1]
    paths = {"meshed": (blocks, ctx), "unmeshed": (params, None)}
    state = {}
    with torch.no_grad():
        for name, (weights, step_ctx) in paths.items():
            prefill = make_prefill_step(cfg, cache_headroom=steps * (repeats + 1), ctx=step_ctx)
            logits, cache = prefill(weights, {"tokens": tokens})
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            state[name] = [make_serve_step(cfg, ctx=step_ctx), weights, tok, cache, prompt]
        times = {name: [] for name in paths}
        for rep in range(repeats + 1):
            for name in paths:
                step, weights, tok, cache, pos = state[name]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(steps):
                    tok, _, cache = step(weights, {"token": tok,
                                                   "pos": torch.tensor(pos, device=tok.device)},
                                         cache)
                    pos += 1
                torch.cuda.synchronize()
                if rep:                 # pass 0 warms both paths up
                    times[name].append((time.perf_counter() - t0) / steps * 1e3)
                state[name][2:] = [tok, cache, pos]
    return times


def summary(times: dict) -> dict:
    out = {name: dict(ms=ts, median=statistics.median(ts), min=min(ts), max=max(ts))
           for name, ts in times.items()}
    out["ratio_of_medians"] = out["meshed"]["median"] / out["unmeshed"]["median"]
    return out


def decode_main(args, label: str) -> dict:
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import smoke_mesh
    from repro_torch.launch.multidevice_demo import init_world
    from repro_torch.models.transformer import init_params, param_specs
    from repro_torch.sharding.ctx import ShardCtx
    from repro_torch.sharding.params import shard_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    init_world(0, 1, "nccl")
    results = {}
    try:
        for arch, layers, extra in (("granite-moe-3b-a800m", 16, {}),
                                    ("rwkv6-7b", 4, {"rwkv_wkv_impl": "pallas"})):
            cfg = dataclasses.replace(get_config(arch), n_layers=layers, **extra)
            params = init_params(cfg, torch.Generator("cuda").manual_seed(0))
            gen = torch.Generator("cuda").manual_seed(7)
            tokens = torch.randint(0, cfg.vocab, (4, 256), generator=gen, device="cuda")
            ctx = ShardCtx(mesh=smoke_mesh(1, 1, "cuda"), attn_shard="explicit")
            blocks = shard_tree(params, param_specs(cfg, ctx.mesh, 1), ctx.mesh)
            res = summary(decode_passes(cfg, params, blocks, ctx, tokens, args.steps,
                                        args.repeats))
            results[arch] = res
            print(f"decode {arch} (full width, {layers} layers, batch 4, prompt 256, "
                  f"{args.repeats} passes of {args.steps} steps after a warm-up pass each; "
                  f"package {args.src or 'this tree'}): ms/step meshed (1, 1) median "
                  f"{res['meshed']['median']:.3f} [{res['meshed']['min']:.3f}, "
                  f"{res['meshed']['max']:.3f}], unmeshed median "
                  f"{res['unmeshed']['median']:.3f} [{res['unmeshed']['min']:.3f}, "
                  f"{res['unmeshed']['max']:.3f}], ratio of medians "
                  f"{res['ratio_of_medians']:.3f}; passes meshed "
                  + " ".join(f"{x:.3f}" for x in res["meshed"]["ms"]) + " unmeshed "
                  + " ".join(f"{x:.3f}" for x in res["unmeshed"]["ms"]) + f" [{label}]",
                  flush=True)
            del params, blocks
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return results


def gemm_main(args, label: str) -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(0)
    results = {}
    for name, k, n in (("wo", 3584 // 16, 3584), ("down", 18944 // 16, 3584)):
        x = torch.randn(16384, k, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).to(torch.bfloat16)
        fns = {"bf16": lambda: x @ w,
               "bf16_out_f32": lambda: torch.mm(x, w, out_dtype=torch.float32),
               "f32_of_widened": lambda: x.float() @ w.float()}
        ms = {}
        for label_fn, fn in fns.items():
            for _ in range(3):
                fn()
            ts = []
            for _ in range(args.repeats):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                torch.cuda.synchronize()
                ts.append(a.elapsed_time(b))
            ms[label_fn] = statistics.median(ts)
        diff = float((fns["bf16_out_f32"]() - fns["f32_of_widened"]()).abs().max())
        flops = 2 * 16384 * k * n
        results[name] = dict(k=k, n=n, tokens=16384, ms=ms, max_abs_diff=diff,
                             tflops={key: flops / v / 1e9 for key, v in ms.items()})
        print(f"gemm {name} 16384 x {k} @ {k} x {n} bf16 inputs, median of {args.repeats}: "
              + ", ".join(f"{key} {v:.4f} ms ({flops / v / 1e9:.1f} TFLOP/s)"
                          for key, v in ms.items())
              + f"; |bf16_out_f32 - f32_of_widened| max {diff:.3e} [{label}]", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["decode", "gemm"])
    ap.add_argument("--src", default=None, help="the directory holding repro_torch "
                    "(default: this tree's src)")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=7)
    args = ap.parse_args(argv)
    src = Path(args.src).resolve() if args.src else Path(__file__).resolve().parents[1] / "src"
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_tp_timing: needs a CUDA card")
    label = card()
    res = decode_main(args, label) if args.what == "decode" else gemm_main(args, label)
    print(json.dumps({"what": args.what, "src": args.src, "card": label, "results": res}))


if __name__ == "__main__":
    main()
