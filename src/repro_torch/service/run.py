"""CLI entry point for the sustained-service harness (DESIGN.md §14).

Replays the async event engine as a long-running streaming service and
writes a versioned artifact:

    results/<name>/v####/service.json
    results/<name>/v####/figures/service_*.svg

Quickstarts (on the current CUDA device; add ``--device cpu`` for the
CPU):

    # a small smoke replay (tiny cell, a few segments, modest rate):
    PYTHONPATH=src python -m repro_torch.service.run --smoke

    # the default deployment shape (N=64, K=16, closed loop) with the
    # Stackelberg solver (kernel K1) per segment:
    PYTHONPATH=src python -m repro_torch.service.run --ra mo

Throughput and latency depend on the machine; `chip_smoke.py` prints the
card's numbers beside its name and power limit.  The port of the JAX
package's `service/run.py`, with its flags and defaults plus `--device`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from ..core import RoundPolicy
from ..experiments.figures import render_service_gallery
from ..experiments.store import next_version_dir, write_record
from ..fl.sim import SimConfig
from .harness import ServiceConfig, SustainedService

__all__ = ["build_service_config", "main"]

# One tiny deployment every environment can replay in about a minute.
SMOKE = dict(devices=8, subchannels=3, samples=96, batch=16, local_steps=1,
             segment_events=20, eval_every=10, segments=3, rate=40.0,
             budget=1.0, warmup=1, scenario="churn", ra="fix")


def build_service_config(args: argparse.Namespace) -> ServiceConfig:
    sim = SimConfig(
        dataset=args.dataset,
        n_devices=args.devices,
        n_subchannels=args.subchannels,
        n_samples=args.samples,
        batch=args.batch,
        local_steps=args.local_steps,
        seed=args.seed,
        policy=RoundPolicy(ra=args.ra),
        scenario=args.scenario,
        aggregation=args.aggregation,
    )
    return ServiceConfig(
        sim=sim,
        segment_events=args.segment_events,
        eval_every_events=args.eval_every,
        target_rate_events_per_s=args.rate,
        latency_budget_s=args.budget,
        warmup_segments=args.warmup,
    )


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.service.run",
        description="Run the async engine as a sustained streaming service "
                    "and write a versioned results/ artifact.")
    p.add_argument("--smoke", action="store_true",
                   help="CI-sized preset (overrides shape/load defaults; "
                        "explicit flags still win)")
    p.add_argument("--segments", type=int, default=4,
                   help="measured segments to replay (default 4)")
    p.add_argument("--segment-events", type=int, default=100,
                   help="events per compiled segment (default 100)")
    p.add_argument("--eval-every", type=int, default=None,
                   help="eval cadence in events; must divide "
                        "--segment-events (default: once per segment)")
    p.add_argument("--rate", type=float, default=None,
                   help="open-loop arrival rate in events/s "
                        "(default: closed loop, back-to-back)")
    p.add_argument("--budget", type=float, default=1.0,
                   help="SLO latency budget in seconds (default 1.0)")
    p.add_argument("--warmup", type=int, default=1,
                   help="unmeasured warm-up segments (default 1)")
    p.add_argument("--devices", type=int, default=64)
    p.add_argument("--subchannels", type=int, default=16)
    p.add_argument("--dataset", default="mnist")
    p.add_argument("--samples", type=int, default=128)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--local-steps", type=int, default=1)
    p.add_argument("--ra", default="fix", help="resource allocation scheme "
                   "(default 'fix'; 'mo' runs the Stackelberg solver per "
                   "segment)")
    p.add_argument("--scenario", default="churn",
                   help="environment preset (default 'churn' — the "
                        "continuous-churn steady state)")
    p.add_argument("--aggregation", default="async")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--name", default="sustained_service",
                   help="artifact name under the results root")
    p.add_argument("--results-root", default="results")
    p.add_argument("--no-figures", action="store_true",
                   help="skip SVG rendering")
    p.add_argument("--device", default=None,
                   help="torch device, 'cuda[:i]' or 'cpu' (default: the "
                        "current CUDA device; raises without one)")
    return p


def main(argv: list[str] | None = None) -> int:
    p = _parser()
    args = p.parse_args(argv)
    if args.smoke:
        # Preset fills every value the user did not set explicitly.
        defaults = {a.dest: a.default for a in p._actions}
        for flag, value in SMOKE.items():
            if getattr(args, flag) == defaults[flag]:
                setattr(args, flag, value)

    cfg = build_service_config(args)
    sim = cfg.sim
    svc = SustainedService(cfg, device=args.device)
    print(f"[service] {sim.dataset} N={sim.n_devices} K={sim.n_subchannels} "
          f"scenario={args.scenario} aggregation={args.aggregation} "
          f"segment={cfg.segment_events}ev x{args.segments} "
          f"rate={cfg.target_rate_events_per_s or 'closed-loop'} "
          f"device={svc.device}")
    record = svc.serve(args.segments, progress=lambda m: print(f"[service] {m}"))

    out_dir = next_version_dir(args.results_root, args.name)
    path = write_record(record, out_dir, filename="service.json")
    figs = []
    if not args.no_figures:
        figs = render_service_gallery(record, out_dir / "figures")

    s = record["summary"]
    print(f"[service] wrote {path}" +
          (f" (+{len(figs)} figures)" if figs else ""))
    print(f"[service] events={s['events']} "
          f"throughput={s['throughput_events_per_s']:.1f} ev/s "
          f"p50={s['latency_s']['p50'] * 1e3:.0f}ms "
          f"p95={s['latency_s']['p95'] * 1e3:.0f}ms "
          f"p99={s['latency_s']['p99'] * 1e3:.0f}ms "
          f"slo={s['slo']['attained']:.0%} @ {s['slo']['budget_s']:g}s")
    print(json.dumps({"out_dir": str(out_dir),
                      "throughput_events_per_s":
                          s["throughput_events_per_s"],
                      "p99_latency_s": s["latency_s"]["p99"],
                      "slo_attained": s["slo"]["attained"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
