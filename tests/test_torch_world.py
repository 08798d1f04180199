"""The port's NumPy world against the JAX package, bit for bit.

`fl.sim._prepare` (dataset, partition, padded client buffers, channel
horizon, injected permutations, scenario traces) for the same seed, and the
NumPy copies behind it and behind the per-round leader (`scenarios`,
`data`, `core.stackelberg.plan_round`).
"""
from _torch_oracle import SMALL  # noqa: I001  (alias first)

import dataclasses

import numpy as np
import pytest

from repro.core import RoundPolicy as JaxPolicy
from repro.core import RoundRandomness as JaxRandomness
from repro.core import init_aou as jax_init_aou
from repro.core import plan_round as jax_plan_round
from repro.fl.sim import SimConfig as JaxSimConfig
from repro.fl.sim import _prepare as jax_prepare
from repro.scenarios import PRESETS as JAX_PRESETS
from repro.scenarios import generate_traces as jax_generate_traces
from repro_torch.core import RoundPolicy, RoundRandomness, init_aou, plan_round
from repro_torch.core.monotonic import fixed_ra
from repro_torch.fl.sim import SimConfig, _prepare
from repro_torch.scenarios import PRESETS, generate_traces

_ARRAYS = ("beta", "h2_all", "clusters", "fixed_ids", "sel_perms",
           "assign_perms", "distances", "avail", "slowdown", "emax_all")


def _pair(**kw):
    return SimConfig(**{**SMALL, **kw}), JaxSimConfig(**{**SMALL, **kw})


@pytest.mark.parametrize("scenario", ["static", "churn"])
@pytest.mark.parametrize("dataset", ["mnist", "sst2"])
def test_prepare_is_bit_identical(scenario, dataset):
    cfg, jcfg = _pair(dataset=dataset, scenario=scenario)
    got, want = _prepare(cfg, "cpu"), jax_prepare(jcfg)
    for name in _ARRAYS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for name in ("x_all", "y_all", "m_all"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(got.ds.x, want.ds.x)
    np.testing.assert_array_equal(got.ds.y, want.ds.y)
    assert got.rng.bit_generator.state == want.rng.bit_generator.state
    if scenario == "churn":
        assert not got.avail.all()


def test_scenario_presets_match():
    assert sorted(PRESETS) == sorted(JAX_PRESETS)
    for name in PRESETS:
        assert dataclasses.asdict(PRESETS[name]) == dataclasses.asdict(JAX_PRESETS[name])


@pytest.mark.parametrize("scenario", sorted(JAX_PRESETS))
def test_generate_traces_bit_identical(scenario):
    cfg, jcfg = _pair()
    got = generate_traces(5, cfg.wireless(), scenario, rounds=4)
    want = jax_generate_traces(5, jcfg.wireless(), scenario, rounds=4)
    for name in ("h2_all", "distances_m", "avail", "slowdown", "e_max_j"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


@pytest.mark.parametrize("ds", ["alg3", "aou_topk", "random", "cluster", "fixed"])
@pytest.mark.parametrize("sa", ["matching", "random"])
def test_plan_round_copy_is_bit_identical(ds, sa):
    """Four rounds of the NumPy leader on the same world and Γ, carrying
    each package's own AoU state."""
    cfg, jcfg = _pair(rounds=4)
    prep = _prepare(cfg, "cpu")
    ra = fixed_ra(prep.beta[None, None, :], prep.h2_all, prep.wcfg)
    aou, jaou = init_aou(cfg.n_devices), jax_init_aou(cfg.n_devices)
    for t in range(cfg.rounds):
        ra_t = type(ra)(**{k: v[t] for k, v in dataclasses.asdict(ra).items()})
        kw = dict(round_idx=t, clusters=prep.clusters, fixed_ids=prep.fixed_ids, ra=ra_t)
        got = plan_round(aou, prep.beta, prep.h2_all[t], prep.wcfg, None,
                         policy=RoundPolicy(ds=ds, sa=sa),
                         randomness=RoundRandomness(prep.sel_perms[t], prep.assign_perms[t]),
                         **kw)
        want = jax_plan_round(jaou, prep.beta, prep.h2_all[t], jcfg.wireless(), None,
                              policy=JaxPolicy(ds=ds, sa=sa),
                              randomness=JaxRandomness(prep.sel_perms[t], prep.assign_perms[t]),
                              **kw)
        for name in ("selected", "transmitted", "channel_of", "time_per_device",
                     "energy_per_device"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
        assert got.latency_s == want.latency_s
        aou, jaou = got.aou_next, want.aou_next
        np.testing.assert_array_equal(aou.age, jaou.age)
