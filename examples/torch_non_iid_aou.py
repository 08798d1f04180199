"""Beyond-paper ablation on the PyTorch port (`repro_torch`): AoU-weighted
selection under label-skewed NON-IID data (Dirichlet partition).

The port's counterpart of `examples/non_iid_aou.py`.  The paper evaluates
imbalanced IID only.  Under label skew each device's update is more
distinctive, so skipping a device for many rounds leaves a bigger hole in
the aggregate — AoU's freshness prior should earn a LARGER margin over
random selection than in the IID setting.  This script measures that
margin at two Dirichlet concentrations.

  PYTHONPATH=src python examples/torch_non_iid_aou.py
  PYTHONPATH=src python examples/torch_non_iid_aou.py --device cpu

It runs on the current CUDA device unless ``--device cpu`` is given, and
raises without either.
"""
import argparse

import numpy as np

from repro_torch.core import RoundPolicy
from repro_torch.device import resolve_device
from repro_torch.fl import SimConfig, run_simulation


def run(device, rounds=60, n_samples=500, seeds=(0, 1)):
    print(f"{'partition':22s} {'proposed':>9s} {'random':>9s} {'margin':>8s}")
    for label, kw in [
        ("imbalanced IID", dict(partition="iid")),
        ("dirichlet a=0.5", dict(partition="dirichlet", dirichlet_alpha=0.5)),
        ("dirichlet a=0.1", dict(partition="dirichlet", dirichlet_alpha=0.1)),
    ]:
        res = {}
        for name, ds in [("proposed", "alg3"), ("random", "random")]:
            losses = []
            for s in seeds:
                h = run_simulation(SimConfig(
                    dataset="mnist", rounds=rounds, n_samples=n_samples,
                    policy=RoundPolicy(ds=ds), seed=s, eval_every=max(rounds // 4, 1),
                    **kw), device=device)
                losses.append(h.global_loss[-1])
            res[name] = float(np.mean(losses))
        margin = (res["random"] - res["proposed"]) / res["random"] * 100
        print(f"{label:22s} {res['proposed']:9.4f} {res['random']:9.4f} "
              f"{margin:+7.1f}%")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device, 'cuda[:i]' or 'cpu' (default: the "
                         "current CUDA device; raises without one)")
    run(resolve_device(ap.parse_args(argv).device))


if __name__ == "__main__":
    main()
