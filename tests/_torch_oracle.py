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
# The same for the hierarchy (the JAX package's tests/test_hier_async_*.py).
HIER_SMALL = dict(rounds=6, n_cells=2, devices_per_cell=8, subchannels_per_cell=3,
                  n_samples=96, batch=16, local_steps=2, eval_every=2)


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


def jax_training_draws(cfg, k_slots=None):
    """The JAX package's exact learning-plane draws for `cfg`: its initial
    parameters (numpy pytree) and a function giving each training event's
    (K, local_steps, batch) minibatch uniforms, in the order
    `fl/sim.py::_run_prepared`, `fl/engine_common.py::train_clients` and
    `fl/client.py` consume the PRNG stream (the same on all three
    engines).  `k_slots` overrides K = `cfg.n_subchannels` (a hierarchy
    trains one cell's K slots per split)."""
    from repro.fl.sim import TABLE1
    from repro.models.small import get_small_model

    batch = cfg.batch or TABLE1[cfg.dataset]["batch"]
    n_slots = cfg.n_subchannels if k_slots is None else k_slots
    key = jax.random.PRNGKey(cfg.seed)
    key, k_init = jax.random.split(key)
    params = jax.tree_util.tree_map(
        np.asarray, get_small_model(cfg.dataset).init(k_init))
    state = {"key": key}

    def next_uniforms() -> np.ndarray:
        state["key"], k_round = jax.random.split(state["key"])
        slots = jax.random.split(k_round, n_slots)
        return np.asarray(
            [[np.asarray(jax.random.uniform(k, (batch,)))
              for k in jax.random.split(ks, cfg.local_steps)] for ks in slots],
            dtype=np.float32)

    return params, next_uniforms


def _port_jax_draws(cfg, batch, device, k=None):
    """`jax_training_draws` in the shape of the port's `training_draws`."""
    import torch

    from repro_torch.models.small import params_from_jax

    params, next_u = jax_training_draws(cfg, k)
    return (params_from_jax(params, device=device),
            lambda: torch.from_numpy(next_u()).to(device))


def inject_jax_draws(monkeypatch):
    """Make the port's simulations draw exactly what the JAX package draws."""
    import repro_torch.fl.sim as port_sim

    monkeypatch.setattr(port_sim, "training_draws", _port_jax_draws)


def inject_jax_hier_draws(monkeypatch):
    """The same for the port's hierarchy: one (subchannels_per_cell,
    local_steps, batch) block per (round, cell) in which that cell trains,
    in cell order, from the one key all cells share
    (`fl/hierarchical.py:681-684`, `fl/engine_common.py:55-64`)."""
    import repro_torch.fl.hierarchical as port_hier

    monkeypatch.setattr(port_hier, "training_draws", _port_jax_draws)


# --------------------------------------------------------------------------
# The model zoo (tests/test_torch_llm_*.py)
# --------------------------------------------------------------------------

def f32(x) -> np.ndarray:
    """A JAX array, torch tensor or numpy array as float64 numpy (bf16 too)."""
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy().astype(np.float64)
    return np.asarray(jax.numpy.asarray(x).astype(jax.numpy.float32), np.float64)


def rel_max(got, want) -> float:
    """max |got - want| over max |want|: the JAX package's serving metric
    (tests/test_serving.py)."""
    got, want = f32(got), f32(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def bf16_ulp(x) -> np.ndarray:
    """One bf16 ulp (8 significant bits) at |x|, elementwise."""
    x = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0**-126)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def jax_llm_params(cfg, seed: int = 0):
    """The JAX package's `init_params(cfg, PRNGKey(seed))` with numpy leaves."""
    from repro.models.transformer import init_params
    return jax.tree_util.tree_map(np.asarray, init_params(cfg, jax.random.PRNGKey(seed)))
