"""Quickstart on the PyTorch port (`repro_torch`): the paper in about a minute.

The port's counterpart of `examples/quickstart.py`:

1. Solve ONE Stackelberg round: MO-RA (Alg. 1) -> M-SA (Alg. 2) -> AoU
   device selection (Alg. 3), and print the round plan (NumPy, the same
   text as the JAX example prints).
2. Run a short wireless-FL simulation comparing the proposed scheme against
   random device selection on synthetic MNIST, Γ on kernel K1 and every
   aggregation on kernel K3 when it runs on the card.

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

It runs on the current CUDA device unless ``--device cpu`` is given, and
raises without either.
"""
import argparse

import numpy as np

from repro_torch.core import RoundPolicy, WirelessConfig, init_aou, plan_round
from repro_torch.core.wireless import sample_channel_gains, sample_topology
from repro_torch.device import resolve_device
from repro_torch.fl import SimConfig, run_simulation


def one_round():
    print("=" * 60)
    print("ONE STACKELBERG ROUND  (N=20 devices, K=4 sub-channels)")
    print("=" * 60)
    cfg = WirelessConfig()
    rng = np.random.default_rng(0)
    topo = sample_topology(rng, cfg)
    h2 = sample_channel_gains(rng, cfg, topo)
    beta = rng.integers(10, 50, cfg.n_devices).astype(float)
    aou = init_aou(cfg.n_devices)

    plan = plan_round(aou, beta, h2, cfg, rng, policy=RoundPolicy())
    print(f"Prop-1 feasible (device,channel) pairs: "
          f"{plan.feasible.sum()}/{plan.feasible.size}")
    print(f"selected devices : {np.where(plan.selected)[0].tolist()}")
    print(f"transmitting     : {np.where(plan.transmitted)[0].tolist()}")
    for n in np.where(plan.transmitted)[0]:
        print(f"  device {n:2d}: sub-channel {plan.channel_of[n]}, "
              f"tau*={plan.tau[n]:.3f} p*={plan.p[n]:.3f} "
              f"T={plan.time_per_device[n]:.2f}s "
              f"E={plan.energy_per_device[n]*1e3:.1f}mJ "
              f"(budget {cfg.e_max_j*1e3:.0f}mJ)")
    print(f"round latency (eq. 9): {plan.latency_s:.2f}s")


def short_sim(device, rounds: int = 30, n_samples: int = 400):
    print()
    print("=" * 60)
    print(f"{rounds}-ROUND FL SIMULATION  (synthetic MNIST, real training)")
    print("=" * 60)
    for name, ds in [("proposed (Alg.3 + MO-RA + M-SA)", "alg3"),
                     ("random device selection", "random")]:
        h = run_simulation(SimConfig(dataset="mnist", rounds=rounds,
                                     policy=RoundPolicy(ds=ds),
                                     n_samples=n_samples, eval_every=10),
                           device=device)
        print(f"{name:36s} loss {h.global_loss[0]:.3f} -> {h.global_loss[-1]:.3f}"
              f"  acc {h.accuracy[-1]:.3f}  conv-time {h.cum_time_s[-1]:.0f}s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device, 'cuda[:i]' or 'cpu' (default: the "
                         "current CUDA device; raises without one)")
    device = resolve_device(ap.parse_args(argv).device)
    one_round()
    short_sim(device)


if __name__ == "__main__":
    main()
