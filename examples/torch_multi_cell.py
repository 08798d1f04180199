"""Multi-cell (hierarchical) FLOWN on the PyTorch port (`repro_torch`): two
base stations each run the paper's full Stackelberg round over their own
devices and channels; cell models merge by transmitted data size
(`repro_torch.fl.hierarchical`).

The port's counterpart of `examples/multi_cell.py`.  Runs the
device-resident scan engine (cells a Python loop in the round body, Γ for
both cells in one K1 launch, eq. 34 on K3 at both tiers when it runs on the
card); pass --engine loop for the host reference.

  PYTHONPATH=src python examples/torch_multi_cell.py [--engine loop]
  PYTHONPATH=src python examples/torch_multi_cell.py --device cpu

It runs on the current CUDA device unless ``--device cpu`` is given, and
raises without either.
"""
import argparse

from repro_torch.core import RoundPolicy
from repro_torch.device import resolve_device
from repro_torch.fl import HierSimConfig, run_hierarchical


def compare(engine: str, device, rounds: int = 30) -> None:
    for name, ds in [("proposed", "alg3"), ("random", "random")]:
        out = run_hierarchical(HierSimConfig(
            rounds=rounds, policy=RoundPolicy(ds=ds), seed=0), engine=engine,
            device=device)
        print(f"2-cell {name:10s} [{engine}]: loss {out['loss'][0]:.3f} -> "
              f"{out['loss'][-1]:.3f}  "
              f"mean round latency {out['latency'].mean():.2f}s "
              f"(max over cells, cells parallel)  "
              f"wall {out['wall_s']:.1f}s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--engine", choices=("scan", "loop"), default="scan")
    ap.add_argument("--device", default=None,
                    help="torch device, 'cuda[:i]' or 'cpu' (default: the "
                         "current CUDA device; raises without one)")
    args = ap.parse_args(argv)
    compare(args.engine, resolve_device(args.device))


if __name__ == "__main__":
    main()
