"""Shared set-up of the differential tests of the PyTorch port
(tests/test_torch_*.py): the JAX package as the oracle.

Importing this module installs `jax.experimental.enable_x64` where the
installed jax no longer has it (it became `jax.enable_x64`), because
`repro.core.monotonic_jax` imports it by that name: without the alias the
JAX package cannot be imported at all.  Every test_torch_* file that
imports `repro` imports this module first.
"""
from __future__ import annotations

import contextlib

import jax
import jax.experimental
import numpy as np

if not hasattr(jax.experimental, "enable_x64"):
    @contextlib.contextmanager
    def _enable_x64(new_val: bool = True):
        with jax.enable_x64(new_val):
            yield

    jax.experimental.enable_x64 = _enable_x64

enable_x64 = jax.experimental.enable_x64

# The small simulation size the port's differential tests run at.
SMALL = dict(rounds=6, n_devices=8, n_subchannels=3, n_samples=96, batch=16,
             local_steps=2, eval_every=2)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300),
                        initial=0.0))


def feasible_pairs(n: int, seed: int):
    """(beta, h2, cfg) of Prop-1 feasible pairs, drawn as the JAX package's
    fused-kernel tests draw them (h2 ~ 3 Exp(1), beta ~ U{5..59})."""
    from repro.core import WirelessConfig
    from repro.core.feasibility import is_infeasible

    cfg = WirelessConfig()
    rng = np.random.default_rng(seed)
    h2 = rng.exponential(size=n) * 3
    beta = rng.integers(5, 60, n).astype(np.float64)
    keep = ~is_infeasible(h2, cfg, np.full(n, cfg.e_max_j))
    return beta[keep], h2[keep], cfg


def jax_training_draws(cfg):
    """The JAX package's exact learning-plane draws for `cfg`: its initial
    parameters (numpy pytree) and a function giving each training event's
    (K, local_steps, batch) minibatch uniforms, in the order
    `fl/sim.py::_run_prepared`, `fl/engine_common.py::train_clients` and
    `fl/client.py` consume the PRNG stream (the same on all three
    engines)."""
    from repro.fl.sim import TABLE1
    from repro.models.small import get_small_model

    batch = cfg.batch or TABLE1[cfg.dataset]["batch"]
    key = jax.random.PRNGKey(cfg.seed)
    key, k_init = jax.random.split(key)
    params = jax.tree_util.tree_map(
        np.asarray, get_small_model(cfg.dataset).init(k_init))
    state = {"key": key}

    def next_uniforms() -> np.ndarray:
        state["key"], k_round = jax.random.split(state["key"])
        slots = jax.random.split(k_round, cfg.n_subchannels)
        return np.asarray(
            [[np.asarray(jax.random.uniform(k, (batch,)))
              for k in jax.random.split(ks, cfg.local_steps)] for ks in slots],
            dtype=np.float32)

    return params, next_uniforms


def inject_jax_draws(monkeypatch):
    """Make the port's simulations draw exactly what the JAX package draws."""
    import torch

    import repro_torch.fl.sim as port_sim
    from repro_torch.models.small import params_from_jax

    def draws(cfg, batch, device):
        params, next_u = jax_training_draws(cfg)
        return (params_from_jax(params, device=device),
                lambda: torch.from_numpy(next_u()).to(device))

    monkeypatch.setattr(port_sim, "training_draws", draws)
