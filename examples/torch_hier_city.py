"""City-scale two-tier comparison on the PyTorch port (`repro_torch`): sync
vs async aggregation at BOTH tiers.

The port's counterpart of `examples/hier_city.py`, with the same specs and
flags plus ``--device``.  Runs the hierarchical sweep grid — one
shared-mobility city of C cells, each cell a buffered staleness-weighted
event loop, the global server itself a buffered staleness-weighted
aggregator over cell commits — crossing the cell-tier and global-tier
server disciplines under device churn, then writes:

  results/<name>/v####/sweep.json     versioned metrics + curves artifact
  results/<name>/v####/figures/*.svg  per-discipline facets + the
                                      time-to-target comparison

  PYTHONPATH=src python examples/torch_hier_city.py            # reduced artifact
  PYTHONPATH=src python examples/torch_hier_city.py --smoke    # small grid
  PYTHONPATH=src python examples/torch_hier_city.py --smoke --device cpu

The sweep's hierarchical cells run as two `run_hier_many` groups, each one
batch on a config axis: the sync/sync cells on the scan engine, the three
disciplines with an async tier on the two-tier event engine.  It runs on the
current CUDA device unless ``--device cpu`` is given, and raises without
either.

The headline row is `churn · async/g.async` vs `churn · sync/g.sync`:
with stragglers at both tiers, the fully asynchronous hierarchy reaches
the target loss in less simulated time than the doubly-barriered one
(neither tier ever waits for the slowest device / slowest cell).
"""
import argparse

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.experiments import SweepSpec, run_sweep


def build_spec(args: argparse.Namespace) -> SweepSpec:
    disciplines = dict(aggregation=("sync", "async"),
                       global_aggregation=("sync", "async"))
    if args.smoke:       # 4 cells x 4 discipline combos
        return SweepSpec(
            name=args.name, datasets="mnist", ds=("alg3",),
            scenarios=("churn",), cell_counts=(4,), **disciplines,
            seeds=(0,), rounds=12, n_devices=16, n_subchannels=8,
            target_loss=args.target_loss,
            overrides={"n_samples": 128, "batch": 16, "eval_every": 3,
                       "local_steps": 2})
    # default: reduced city (4 cells x 8 devices)
    return SweepSpec(
        name=args.name, datasets="mnist", ds=("alg3",),
        scenarios=("churn",), cell_counts=(4,), **disciplines,
        seeds=tuple(range(args.seeds)), rounds=args.rounds,
        n_devices=32, n_subchannels=8, target_loss=args.target_loss,
        overrides={"n_samples": 400, "batch": 32, "eval_every": 5,
                   "local_steps": 2})


def run(spec: SweepSpec, device, results_root: str):
    """The sweep of `spec` on `device`, its record and gallery under
    `results_root`, and the per-discipline table; returns the result."""
    print(f"hier sweep {spec.name!r}: {spec.n_cells} cells "
          f"(C={spec.cell_counts[0]} towers, {len(spec.aggregation)} cell-"
          f"tier x {len(spec.global_aggregation)} global-tier disciplines "
          f"x {len(spec.seeds)} seeds), {spec.rounds} events")
    res = run_sweep(spec, device=device, results_root=results_root, figures=True)
    print(f"wrote {res.out_dir}/sweep.json "
          f"(+ figures/) in {res.record['wall_s']:.1f}s on "
          f"{res.record['env']['device_name']}")

    print(f"\n{'discipline (cell/global)':26s} {'final loss':>10s} "
          f"{'t→{:g} (s)'.format(spec.target_loss):>12s} {'cum lat (s)':>12s}")
    rows: dict[tuple, list[dict]] = {}
    for c in res.record["cells"]:
        rows.setdefault((c["aggregation"], c["global_aggregation"]),
                        []).append(c["metrics"])
    t2t_by_disc = {}
    for (ag, g), ms in sorted(rows.items()):
        t2t = [m["time_to_target_s"] for m in ms]
        t2t_s = "-" if any(t is None for t in t2t) else f"{np.mean(t2t):.1f}"
        if not any(t is None for t in t2t):
            t2t_by_disc[(ag, g)] = float(np.mean(t2t))
        print(f"{ag + '/g.' + g:26s} "
              f"{np.mean([m['final_loss'] for m in ms]):10.4f} "
              f"{t2t_s:>12s} "
              f"{np.mean([m['cumulative_latency_s'] for m in ms]):12.1f}")
    sync2, async2 = (t2t_by_disc.get(("sync", "sync")),
                     t2t_by_disc.get(("async", "async")))
    if sync2 is not None and async2 is not None:
        print(f"\nasync two-tier vs sync two-tier time-to-target: "
              f"{async2:.1f}s vs {sync2:.1f}s "
              f"({sync2 / async2:.2f}x faster)" if async2 < sync2 else
              f"\nWARNING: async two-tier ({async2:.1f}s) did not beat "
              f"sync ({sync2:.1f}s) at this scale")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--name", default="hier_async",
                    help="sweep/artifact name under --results-root")
    ap.add_argument("--results-root", default="results")
    ap.add_argument("--seeds", type=int, default=2,
                    help="number of world seeds (0..seeds-1)")
    ap.add_argument("--rounds", type=int, default=60,
                    help="event horizon per cell run")
    ap.add_argument("--target-loss", type=float, default=1.0,
                    help="time-to-target threshold")
    ap.add_argument("--smoke", action="store_true",
                    help="small grid (1 seed, 12 events)")
    ap.add_argument("--device", default=None,
                    help="torch device, 'cuda[:i]' or 'cpu' (default: the "
                         "current CUDA device; raises without one)")
    args = ap.parse_args(argv)
    run(build_spec(args), resolve_device(args.device), args.results_root)


if __name__ == "__main__":
    main()
