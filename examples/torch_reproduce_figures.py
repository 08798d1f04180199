"""Reproduce the paper's headline comparison from ONE declarative sweep, on
the PyTorch port (`repro_torch`).

The port's counterpart of `examples/reproduce_figures.py`, with the same
specs and flags plus ``--device``: the proposed Algorithm 3 against the
random / fixed / cluster baselines (all with MO-RA + M-SA) over several
seeds, Γ on kernel K1 and every aggregation on kernel K3 when it runs on
the card.  It writes:

  results/<name>/v####/sweep.json     versioned metrics + curves artifact
  results/<name>/v####/figures/*.svg  convergence curves (vs round and vs
                                      simulated time), sub-channel
                                      utilization bars, latency CDF

  PYTHONPATH=src python examples/torch_reproduce_figures.py            # reduced
  PYTHONPATH=src python examples/torch_reproduce_figures.py --full     # paper scale
  PYTHONPATH=src python examples/torch_reproduce_figures.py --smoke    # small grid
  PYTHONPATH=src python examples/torch_reproduce_figures.py --smoke --device cpu

It runs on the current CUDA device unless ``--device cpu`` is given.  The
--scenario and --aggregation axes work as in the JAX example.  Every run
appends a NEW version directory under --results-root.
"""
import argparse

import numpy as np

from repro_torch.core import PAPER_BASELINE_DS
from repro_torch.experiments import SweepSpec, run_sweep


def build_spec(args: argparse.Namespace) -> SweepSpec:
    scenarios = tuple(args.scenario) if args.scenario else ("static",)
    aggregation = tuple(args.aggregation) if args.aggregation else ("sync",)
    if args.smoke:       # 2 policies x 2 seeds
        return SweepSpec(
            name=args.name, datasets="mnist",
            ds=tuple(args.ds) if args.ds else ("alg3", "random"),
            scenarios=scenarios, aggregation=aggregation,
            seeds=(0, 1), rounds=12, n_devices=12, n_subchannels=4,
            target_loss=args.target_loss,
            overrides={"n_samples": 128, "batch": 16, "eval_every": 3,
                       "local_steps": 2})
    if args.full:        # paper scale (Table I / Sec. VI)
        return SweepSpec(
            name=args.name, datasets="mnist",
            ds=tuple(args.ds) if args.ds else PAPER_BASELINE_DS,
            scenarios=scenarios, aggregation=aggregation,
            seeds=tuple(range(args.seeds)), rounds=300,
            n_devices=20, n_subchannels=4, target_loss=args.target_loss)
    # default: reduced scale, same scheme ordering (DESIGN.md §2)
    return SweepSpec(
        name=args.name, datasets="mnist",
        ds=tuple(args.ds) if args.ds else PAPER_BASELINE_DS,
        scenarios=scenarios, aggregation=aggregation,
        seeds=tuple(range(args.seeds)), rounds=60,
        n_devices=20, n_subchannels=4, target_loss=args.target_loss,
        overrides={"n_samples": 500, "eval_every": 5})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--name", default="fig3_convergence",
                    help="sweep/artifact name under --results-root")
    ap.add_argument("--results-root", default="results")
    ap.add_argument("--seeds", type=int, default=2,
                    help="number of world seeds (0..seeds-1)")
    ap.add_argument("--target-loss", type=float, default=1.0,
                    help="rounds/time-to-target threshold")
    ap.add_argument("--engine", choices=("scan", "loop"), default="scan")
    ap.add_argument("--full", action="store_true", help="paper scale")
    ap.add_argument("--smoke", action="store_true",
                    help="small grid (2 policies x 2 seeds)")
    ap.add_argument("--scenario", action="append", default=None,
                    metavar="PRESET",
                    help="environment scenario preset (repeatable; adds a "
                         "scenario axis to the grid — see repro_torch.scenarios)")
    ap.add_argument("--aggregation", action="append", default=None,
                    metavar="PRESET",
                    help="server-aggregation preset (repeatable; sync / "
                         "async / async_const / async_full — async cells "
                         "run the buffered event engine, DESIGN.md §12)")
    ap.add_argument("--ds", action="append", default=None, metavar="SCHEME",
                    help="device-selection scheme axis override "
                         "(repeatable; default: the per-mode policy grid)")
    ap.add_argument("--device", default=None,
                    help="torch device, 'cuda[:i]' or 'cpu' (default: the "
                         "current CUDA device; raises without one)")
    args = ap.parse_args()

    spec = build_spec(args)
    print(f"sweep {spec.name!r}: {spec.n_cells} cells "
          f"({len(spec.policies)} policies x {len(spec.scenarios)} scenarios "
          f"x {len(spec.aggregation)} aggregations x {len(spec.seeds)} "
          f"seeds), {spec.rounds} rounds, engine={args.engine}")
    res = run_sweep(spec, engine=args.engine, device=args.device,
                    results_root=args.results_root, figures=True)
    print(f"wrote {res.out_dir}/sweep.json "
          f"(+ figures/) in {res.record['wall_s']:.1f}s on "
          f"{res.record['env']['device_name']}")

    print(f"\n{'policy':34s} {'final loss':>10s} {'rounds→{:g}'.format(spec.target_loss):>10s} "
          f"{'util':>6s} {'cum lat (s)':>12s}")
    rows: dict[str, list[dict]] = {}
    many_sc = len(spec.scenarios) > 1
    many_ag = len(spec.aggregation) > 1
    for c in res.record["cells"]:
        label = c["policy"]["label"]
        if many_sc:   # never pool metrics across environments
            label = f"{label} @{c['scenario']}"
        if many_ag:   # ... nor across server disciplines
            label = f"{label} [{c['aggregation']}]"
        rows.setdefault(label, []).append(c["metrics"])
    for label, ms in rows.items():
        r2t = [m["rounds_to_target"] for m in ms]
        r2t_s = ("-" if any(r is None for r in r2t)
                 else f"{np.mean(r2t):.1f}")
        print(f"{label:34s} {np.mean([m['final_loss'] for m in ms]):10.4f} "
              f"{r2t_s:>10s} "
              f"{np.mean([m['mean_subchannel_utilization'] for m in ms]):6.2f} "
              f"{np.mean([m['cumulative_latency_s'] for m in ms]):12.1f}")


if __name__ == "__main__":
    main()
