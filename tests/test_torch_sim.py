"""The whole slice: the port's `run_simulation(..., device="cpu")` against
the JAX package's `run_simulation(..., engine="loop", ra_backend="bisect")`
with the JAX initial parameters and minibatch uniforms injected; and three
properties of the package (no JAX import, no silent CPU, unknown engine and
aggregation names refused).

Tolerances: the world, Γ and the leader's decisions are float64 / integer
and agree exactly (tx, AoU, selection counts) or to the log1p ulp carried
through Algorithm 1 (latency and energy, 1e-9 relative).  Loss and accuracy
come out of float32 training whose sums the two frameworks order
differently; over six rounds of two local steps that stays within 1e-4
relative for mnist and sst2 (cifar10's Adam-trained CNN: `_LOSS_RTOL`).
"""
from _torch_oracle import SMALL, inject_jax_draws, rel_err  # noqa: I001  (alias first)

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.fl.sim as port_sim
from repro.core import RoundPolicy as JaxPolicy
from repro.fl import SimConfig as JaxSimConfig
from repro.fl import run_simulation as jax_run_simulation
from repro_torch.core import RoundPolicy
from repro_torch.fl import SimConfig, run_many, run_simulation

_SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


# Loss tolerance per dataset.  cifar10 trains its CNN with Adam (Table I),
# which is ill-conditioned in float32 here: on SMALL its loss differs from
# JAX's by up to 5.4e-4 relative (alg3, static; 6.1e-7 on random, churn),
# while perturbing the port's own initial weights by one ulp (2^-24
# relative, random signs) moves its alg3 loss by 4.2e-4 and 1.7e-3 on two
# draws, with the same tx trace (`test_cifar10_loss_moves_under_one_ulp`);
# with sgd the same CNN moves by under 5e-6.  5e-3 is three times the
# larger one-ulp movement: a real fault in the learning plane (a wrong
# step, a wrong leaf) moves the loss by far more.
_LOSS_RTOL = {"mnist": 1e-4, "sst2": 1e-4, "cifar10": 5e-3}


@pytest.mark.parametrize("ds", ["alg3", "random"])
@pytest.mark.parametrize("dataset", ["mnist", "sst2", "cifar10"])
def test_slice_matches_jax_loop_engine(monkeypatch, dataset, ds):
    inject_jax_draws(monkeypatch)
    kw = dict(SMALL, dataset=dataset, scenario="churn" if ds == "random" else "static")
    got = run_simulation(SimConfig(**kw, policy=RoundPolicy(ds=ds)), device="cpu")
    want = jax_run_simulation(JaxSimConfig(**kw, policy=JaxPolicy(ds=ds)),
                              engine="loop", ra_backend="bisect")
    for name in ("tx_trace", "age_trace", "n_selected", "n_transmitted", "rounds",
                 "deficits"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got.tx_trace.any()
    for name in ("latency_all", "energy_all", "cum_time_s"):
        assert rel_err(getattr(got, name), getattr(want, name)) < 1e-9, name
    assert rel_err(got.global_loss, want.global_loss) < _LOSS_RTOL[dataset]
    np.testing.assert_allclose(got.accuracy, want.accuracy, rtol=1e-4, atol=0)
    assert got.label == want.label


def test_cifar10_loss_moves_under_one_ulp(monkeypatch):
    """What cifar10's loss tolerance rests on: float32 rounding alone, a
    one-ulp perturbation (2^-24 relative, random signs) of the port's own
    initial weights, moves its SMALL loss by more than the 1e-4 that mnist
    and sst2 are held to, while the tx trace stays the same."""
    inject_jax_draws(monkeypatch)
    cfg = SimConfig(**dict(SMALL, dataset="cifar10"))
    base = run_simulation(cfg, device="cpu")
    draws = port_sim.training_draws
    moved = []
    for seed in (1, 2):
        def perturbed(cfg, batch, device, seed=seed):
            params, next_u = draws(cfg, batch, device)
            gen = torch.Generator().manual_seed(seed)
            sign = {k: 2.0 * torch.randint(0, 2, v.shape, generator=gen) - 1.0
                    for k, v in params.items()}
            return {k: v * (1 + 2.0**-24 * sign[k]) for k, v in params.items()}, next_u

        monkeypatch.setattr(port_sim, "training_draws", perturbed)
        got = run_simulation(cfg, device="cpu")
        np.testing.assert_array_equal(got.tx_trace, base.tx_trace)
        moved.append(rel_err(got.global_loss, base.global_loss))
    assert 1e-4 < max(moved) < _LOSS_RTOL["cifar10"], moved


def test_step_solver_gives_the_same_simulation():
    """ra_solver="step" (projection wrapper) and "fused" (whole-solve
    wrapper) reach the same Γ on the CPU, hence the same run."""
    cfg = SimConfig(**SMALL)
    a = run_simulation(cfg, device="cpu")
    b = run_simulation(cfg, device="cpu", ra_solver="step")
    np.testing.assert_array_equal(a.tx_trace, b.tx_trace)
    np.testing.assert_array_equal(a.latency_all, b.latency_all)
    np.testing.assert_array_equal(a.global_loss, b.global_loss)


def test_run_many_shares_worlds_and_keeps_order():
    cfgs = [SimConfig(**SMALL, policy=RoundPolicy(ds=ds)) for ds in ("alg3", "fixed")]
    hists = run_many(cfgs, device="cpu")
    for cfg, h in zip(cfgs, hists):
        solo = run_simulation(cfg, device="cpu")
        np.testing.assert_array_equal(h.tx_trace, solo.tx_trace)
        np.testing.assert_array_equal(h.global_loss, solo.global_loss)


def test_gradnorm_tracking_and_training_progress():
    h = run_simulation(SimConfig(**dict(SMALL, rounds=8), track_gradnorm=True),
                       device="cpu")
    assert np.all(np.isfinite(h.global_loss)) and h.global_loss[-1] < h.global_loss[0]
    assert np.all(h.grad_sq_norms > 0)


def test_package_imports_no_jax():
    """The port stands alone: importing all of it loads no JAX module and
    nothing of the JAX package."""
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(' '.join(names))\n"
        "print(bad, len(names))\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(_SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[-1]) >= 20          # every module was walked
    walked = out.stdout.split()
    for name in ("configs", "data.pipeline", "models.layers", "models.attention",
                 "models.ssm", "models.transformer", "train.serve_step", "launch.serve",
                 "kernels.flash_attention.ops", "kernels.rwkv6_wkv.ops"):
        assert "repro_torch." + name in walked        # the model zoo's modules too


def test_entry_points_refuse_a_silent_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: device=None is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_simulation(SimConfig(**SMALL))


@pytest.mark.parametrize("engine", ["scan", "async"])
def test_unported_engines_raise(engine):
    """Both device engines are ported and run; what the entry points refuse
    is an engine or aggregation name they do not know (ValueError)."""
    h = run_simulation(SimConfig(**dict(SMALL, rounds=2)), engine=engine, device="cpu")
    assert h.tx_trace.shape == (2, SMALL["n_devices"])
    with pytest.raises(ValueError, match="unknown engine"):
        run_simulation(SimConfig(**SMALL), engine=engine + "_v2", device="cpu")
    with pytest.raises(ValueError, match="unknown aggregation"):
        run_simulation(SimConfig(**SMALL, aggregation=engine + "_v2"), engine=engine,
                       device="cpu")
