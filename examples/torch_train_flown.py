"""End-to-end driver on the PyTorch port (`repro_torch`), the paper's kind
of run (FL TRAINING): the full FLOWN pipeline — wireless channel
simulation, Stackelberg round planning, real local training on all
selected devices, eq.-(34) aggregation — for a few hundred rounds on each
dataset and scheme, with a CSV log per run under --out.

The port's counterpart of `examples/train_flown.py`:

  PYTHONPATH=src python examples/torch_train_flown.py                # mnist, 300 rounds
  PYTHONPATH=src python examples/torch_train_flown.py --dataset sst2 --rounds 100
  PYTHONPATH=src python examples/torch_train_flown.py --all-schemes
  PYTHONPATH=src python examples/torch_train_flown.py --rounds 5 --device cpu

It runs on the current CUDA device unless ``--device cpu`` is given, and
raises without either.
"""
import argparse
import csv
import os

from repro_torch.core import RoundPolicy
from repro_torch.device import resolve_device
from repro_torch.fl import SimConfig, run_simulation

SCHEMES = {
    "proposed": RoundPolicy(ds="alg3"),
    "aou_topk": RoundPolicy(ds="aou_topk"),
    "random": RoundPolicy(ds="random"),
    "cluster": RoundPolicy(ds="cluster"),
    "fixed": RoundPolicy(ds="fixed"),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mnist", choices=["mnist", "cifar10", "sst2"])
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--scheme", default="proposed", choices=sorted(SCHEMES))
    ap.add_argument("--all-schemes", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/flown")
    ap.add_argument("--device", default=None,
                    help="torch device, 'cuda[:i]' or 'cpu' (default: the "
                         "current CUDA device; raises without one)")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)

    os.makedirs(a.out, exist_ok=True)
    schemes = sorted(SCHEMES) if a.all_schemes else [a.scheme]
    paths = []
    for name in schemes:
        h = run_simulation(SimConfig(
            dataset=a.dataset, rounds=a.rounds, policy=SCHEMES[name],
            seed=a.seed, eval_every=max(a.rounds // 50, 1)), device=device)
        path = os.path.join(a.out, f"{a.dataset}_{name}.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["round", "global_loss", "accuracy", "latency_s",
                        "cum_time_s", "n_transmitted", "energy_j"])
            for i in range(len(h.rounds)):
                w.writerow([h.rounds[i], h.global_loss[i], h.accuracy[i],
                            h.latency_s[i], h.cum_time_s[i],
                            h.n_transmitted[i], h.energy_j[i]])
        print(f"{a.dataset}/{name}: loss {h.global_loss[0]:.3f} -> "
              f"{h.global_loss[-1]:.3f}, acc {h.accuracy[-1]:.3f}, "
              f"convergence time {h.cum_time_s[-1]:.0f}s "
              f"({h.wall_s:.0f}s wall) -> {path}")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
