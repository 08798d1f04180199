"""Parts of `chip_smoke.py` on one card, measured as its own run does not
measure them.

  python3 examples/torch_smoke_parts.py --service-profile-events 100 --jamba-scan
  python3 examples/torch_smoke_parts.py --profile-readback
  python3 examples/torch_smoke_parts.py --mesh-serve
  python3 examples/torch_smoke_parts.py --adafactor --zoo-train

`--service-profile-events N` runs the smoke run's sweep-and-service phase's
service (`chip_smoke.service_phase`) with a profiled window of N events
(the smoke run profiles 10) and prints the wall time of each of its
sub-steps, the profiler's read-back among them.  `--jamba-scan` times
jamba-v0.1-52b's train step at full width and 2 layers (the donated AdamW
step, batch 8, seq 128, 3 warm steps each) with the Mamba scan's steps
sliced by index, the form `models/ssm.py` had before it sliced them by
unbind, against by unbind, in turns (index, unbind, unbind, index).
`--profile-readback` profiles four of the smoke run's windows (the loop
engine's 30 rounds, granite-moe-3b-a800m served at full depth and
jamba-v0.1-52b at 2 layers, both under the smoke run's ranges, and a warm
rwkv6-7b train step at 2 layers) and reads each twice: by
`chip_smoke.read_trace` and by torch's own read-back (`key_averages()`,
the event tree), as the smoke run read it before; it times both and fails
unless they give the same kernels, counts and ranges (device times within
1e-6 relative).  Then, in `chip_smoke.profile_step`'s order, it profiles
a step and AdamW's update alone four times, the step's window read by
each read-back in turn, to show the update's window does not depend on
how the window before it was read.  `--mesh-serve` runs phase 19 (a)
alone (`chip_smoke.meshed_serve_phase` in a world of one under NCCL:
granite-moe-3b-a800m at 16 layers, then rwkv6-7b at 4 layers through K5,
each meshed on (1, 1) against unmeshed) and K5 at the meshed path's head
block (`chip_smoke.check_k5`, 4 x 512 x 4 x 64).  `--adafactor` runs
phase 15's donated-Adafactor parts alone: (a) the dry run's train step on
the card (`chip_smoke.ADAFACTOR_RUNS`: deepseek-v3-671b at 4 layers,
jamba-v0.1-52b at 5, qwen1.5-110b at 10), (c) donated against functional
Adafactor, bitwise (`chip_smoke.ADAFACTOR_DONATE_CASES`), and (d) the
meshed donated Adafactor on a (1, 1) mesh under NCCL
(`chip_smoke.meshed_adafactor`); `--zoo-train` runs (b), `train_loop` on
granite-moe-3b-a800m, stablelm-3b and yi-6b at the depths phase 15 uses;
either then holds its runs to phase 16's prediction
(`chip_smoke.dryrun_phase`).  Every line names the card and its power
limit.  Needs a CUDA device.
"""
import argparse
import contextlib
import dataclasses
import gc
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (exits without a CUDA device)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.fl import SimConfig, run_simulation  # noqa: E402
from repro_torch.launch.serve import serve_loop  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.train.optimizer import adamw  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.train.tree import tree_leaves  # noqa: E402


def mamba_forward_by_index(p, cfg, x, state=None):
    """`ssm.mamba_forward` with the scan's steps sliced by index: the
    backward of T index slices adds T zero-filled (B, T, di, N) gradients."""
    b, t, _ = x.shape
    kw = cfg.mamba_d_conv
    if state is None:
        state = ssm.init_mamba_state(cfg, b, x.device)
    xi, z = ssm.dense(p["in_proj"], x).chunk(2, dim=-1)
    xpad = torch.cat([state["conv"], xi], dim=1)
    xc = xpad[:, 0:t] * p["conv_w"][0]
    for i in range(1, kw):
        xc = xc + xpad[:, i:i + t] * p["conv_w"][i]
    xc = F.silu(xc + p["conv_b"])
    dt, b_ssm, c_ssm = ssm._mamba_ssm_inputs(p, cfg, xc)
    a = -torch.exp(p["a_log"])
    xc32 = xc.float()
    da = torch.exp(dt[..., None] * a)
    dbx = dt[..., None] * b_ssm[:, :, None, :] * xc32[..., None]
    h = state["ssm"]
    ys = []
    for i in range(t):
        h = da[:, i] * h + dbx[:, i]
        ys.append(torch.einsum("bdn,bn->bd", h, c_ssm[:, i]))
    y = torch.stack(ys, dim=1) + xc32 * p["d_skip"]
    out = ssm.dense(p["out_proj"], y.to(x.dtype) * F.silu(z))
    conv = xpad[:, -(kw - 1):] if kw > 1 else state["conv"]
    return out, {"ssm": h, "conv": conv}


def jamba_scan() -> None:
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=2)
    params = init_params(cfg, torch.Generator(cs.DEV).manual_seed(0))
    opt = adamw(cs.TRAIN["lr"])
    state = opt.init(params)
    step = make_train_step(cfg, opt, remat=False, donate=True)
    batch = cs.train_batch(cfg, cs.TRAIN["batch"], 128, 2, cs.DEV)
    by_unbind = ssm.mamba_forward
    try:
        for label in ("index", "unbind", "unbind", "index"):
            tf.mamba_forward = mamba_forward_by_index if label == "index" else by_unbind
            params, state, _ = step(params, state, batch)             # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                params, state, _ = step(params, state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 3 * 1e3
            cs.line(f"jamba-v0.1-52b (2 layers) train step, donated AdamW, B 8 seq 128, Mamba "
                    f"scan sliced by {label}: {ms:.2f} ms/step (3 warm steps) [{cs.CARD}]")
    finally:
        tf.mamba_forward = by_unbind


def torch_readback(prof) -> tuple[list, dict]:
    """A profiled window as torch reads it back, the way the smoke run read
    it before `read_trace`: the device events with device time from
    `key_averages()`, and per range the kernels under each range's event
    in torch's event tree."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    kernels = [cs.Kernel(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
               if e.self_device_time_total > 0 and e.device_type == cuda]

    def under(ev) -> tuple[int, float]:
        ks = getattr(ev, "kernels", []) or []
        n, us = len(ks), sum(k.duration for k in ks)
        for c in ev.cpu_children:
            cn, cus = under(c)
            n, us = n + cn, us + cus
        return n, us

    inside: dict = {}
    for e in prof.events():
        if cs.is_range(e.name) and e.device_type == cpu:
            calls, n, us = inside.get(e.name, (0, 0, 0.0))
            kn, kus = under(e)
            inside[e.name] = (calls + 1, n + kn, us + kus)
    return kernels, inside


def close(a: float, b: float) -> bool:
    return abs(a - b) <= 1e-6 * max(abs(a), abs(b))


def compare_readbacks(label: str, prof) -> None:
    """Both read-backs of one window, timed (read_trace first, then torch's,
    which parses the window on first use), held equal."""
    t0 = time.perf_counter()
    mine, my_ranges = cs.read_trace(prof)
    t1 = time.perf_counter()
    theirs, their_ranges = torch_readback(prof)
    t2 = time.perf_counter()
    a = {k.key: k for k in mine}
    b = {k.key: k for k in theirs}
    same = (a.keys() == b.keys() and all(a[k].count == b[k].count and close(a[k].us, b[k].us)
                                          for k in a)
            and my_ranges.keys() == their_ranges.keys()
            and all(my_ranges[r][:2] == their_ranges[r][:2]
                    and close(my_ranges[r][2], their_ranges[r][2]) for r in my_ranges))
    cs.line(f"profile read-back, {label}: {len(a)} device event names, "
            f"{sum(k.count for k in mine)} events, ranges "
            + (", ".join(f"{r} {v[0]} calls {v[1]} kernels" for r, v in my_ranges.items())
               or "none")
            + f"; read_trace {t1 - t0:.2f}s, torch's read-back {t2 - t1:.2f}s; "
            f"equal: {same} [{cs.CARD}]")
    if not same:
        for k in sorted(a.keys() | b.keys()):
            if k not in a or k not in b or a[k].count != b[k].count or not close(a[k].us, b[k].us):
                cs.line(f"  differs: {k[:90]}: read_trace {a.get(k)}, torch {b.get(k)}")
        cs.line(f"  ranges: read_trace {my_ranges}, torch {their_ranges}")
        raise AssertionError(f"{label}: read_trace differs from torch's read-back")


def profiled(fn, ranged: bool = False):
    """fn() under torch.profiler (CPU and CUDA, as the smoke run profiles),
    in the smoke run's ranges if `ranged`; returns the profile."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    ctx = cs.profiled_ranges() if ranged else contextlib.nullcontext()
    with ctx, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def profile_readback() -> None:
    cfg = SimConfig(rounds=30)
    run_simulation(cfg, device=cs.DEV)                                  # warm
    compare_readbacks("loop engine, SimConfig(rounds=30)",
                      profiled(lambda: run_simulation(cfg, device=cs.DEV)))
    serve = dict(cs.SERVE, new_tokens=cs.PROFILE_TOKENS)
    for arch, layers in (("granite-moe-3b-a800m", 0), ("jamba-v0.1-52b", 2)):
        mcfg = get_config(arch)
        mcfg = dataclasses.replace(mcfg, n_layers=layers or mcfg.n_layers)
        params = init_params(mcfg, torch.Generator(cs.DEV).manual_seed(0))
        run = lambda: serve_loop(mcfg, device=cs.DEV, params=params,  # noqa: E731
                                 log_every=serve["new_tokens"], **serve)
        run()                                                           # warm
        compare_readbacks(f"{arch} served ({mcfg.n_layers} layers, "
                          f"{serve['new_tokens']} new tokens)", profiled(run, ranged=True))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    tcfg = dataclasses.replace(get_config("rwkv6-7b"), n_layers=2)
    params = init_params(tcfg, torch.Generator(cs.DEV).manual_seed(0))
    opt = adamw(cs.TRAIN["lr"])
    state = opt.init(params)
    step = make_train_step(tcfg, opt, remat=False, donate=True)
    batch = cs.train_batch(tcfg, cs.TRAIN["batch"], 128, 2, cs.DEV)
    step(params, state, batch)                                          # warm
    compare_readbacks("rwkv6-7b train step (2 layers, donated AdamW)",
                      profiled(lambda: step(params, state, batch)))
    # chip_smoke.profile_step's order: a step's window, then AdamW's update
    # alone; the step's window read by read_trace alone, then by torch's.
    grads = [torch.full_like(p, 1e-3, dtype=torch.float32) for p in tree_leaves(params)]

    def update_alone():
        for update, g in zip(opt.donate(state, params)[1], grads):
            update(g)

    for first in ("read_trace", "torch's read-back", "read_trace", "torch's read-back"):
        prof = profiled(lambda: step(params, state, batch))
        cs.read_trace(prof) if first == "read_trace" else torch_readback(prof)
        del prof
        compare_readbacks(f"rwkv6-7b AdamW update alone, after a step's window read by {first}",
                          profiled(update_alone))


def mesh_serve() -> None:
    """Phase 19 (a) of the smoke run and its K5 check, alone."""
    from repro_torch.launch.multidevice_demo import init_world

    rwkv = get_config("rwkv6-7b")
    cs.check_k5(4, 512, rwkv.n_rwkv_heads // 16, rwkv.rwkv_head_size,
                "head block at model 16 (rwkv6-7b, 4 of 64 heads a rank)", reps=20)
    init_world(0, 1, "nccl")
    try:
        t0 = time.perf_counter()
        cs.meshed_serve_phase(dataclasses.replace(get_config(cs.MESH["arch"]),
                                                  n_layers=cs.MESH["layers"]))
        cs.meshed_serve_phase(
            dataclasses.replace(rwkv, n_layers=cs.MESH_RWKV_LAYERS, rwkv_wkv_impl="pallas"),
            {"rwkv6_wkv": cs.MESH_RWKV_LAYERS * (1 + cs.MESH_SERVE["new"])})
        cs.line(f"phase 19 (a) wall_s={time.perf_counter() - t0:.1f} [{cs.CARD}]")
    finally:
        torch.distributed.destroy_process_group()


def train_parts(adafactor: bool, zoo: bool) -> None:
    """Phase 15's new runs alone (module docstring), then phase 16's
    prediction of each."""
    from repro_torch.launch.multidevice_demo import demo_ctx, fl_batches, init_world

    t0 = time.perf_counter()
    runs = {}
    if adafactor:
        for arch, layers, steps, seq, lr in cs.ADAFACTOR_RUNS:
            runs[f"{arch}/adafactor"] = cs.train_run(arch, layers, steps, seq, adafactor=True,
                                                     lr=lr)
    if zoo:
        for arch, layers, steps, seq in cs.TRAIN_RUNS:
            if arch in cs.PEAK_GATED:
                runs[arch] = cs.train_run(arch, layers, steps, seq)
    if adafactor:
        for case in cs.ADAFACTOR_DONATE_CASES:
            cs.donate_vs_functional(*case, opt_name="adafactor")
        cfg = dataclasses.replace(get_config(cs.MESH["arch"]), n_layers=cs.MESH["layers"])
        b, s = cs.MESH["batch"], cs.MESH["seq"]
        init_world(0, 1, "nccl")
        try:
            ex = {k: torch.as_tensor(v, device=cs.DEV)
                  for k, v in next(fl_batches(cfg, b, s, 0))[0].items()}
            cs.meshed_adafactor(cfg, demo_ctx(1, 1, b, s, "explicit", "cuda"),
                                init_params(cfg, torch.Generator(cs.DEV).manual_seed(0)), ex)
        finally:
            torch.distributed.destroy_process_group()
    cs.dryrun_phase({}, runs)
    cs.line(f"training parts wall_s={time.perf_counter() - t0:.1f} [{cs.CARD}]")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--service-profile-events", type=int, default=0)
    ap.add_argument("--jamba-scan", action="store_true")
    ap.add_argument("--profile-readback", action="store_true")
    ap.add_argument("--mesh-serve", action="store_true")
    ap.add_argument("--adafactor", action="store_true")
    ap.add_argument("--zoo-train", action="store_true")
    args = ap.parse_args(argv)
    cs.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    cs.line(cs.CARD)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.service_profile_events:
        cs.SERVICE_PROFILE_EVENTS = args.service_profile_events
        t0 = time.perf_counter()
        cs.service_phase()
        cs.line(f"service phase ({args.service_profile_events}-event profiled window) "
                f"wall_s={time.perf_counter() - t0:.1f} [{cs.CARD}]")
    if args.jamba_scan:
        jamba_scan()
    if args.profile_readback:
        profile_readback()
    if args.mesh_serve:
        mesh_serve()
    if args.adafactor or args.zoo_train:
        train_parts(args.adafactor, args.zoo_train)


if __name__ == "__main__":
    main()
