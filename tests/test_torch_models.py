"""The port's learning plane against the JAX package: the three paper
models after `params_from_jax`, the two Table-I optimizers, the local
trainer fed the JAX package's exact minibatch uniforms, eq.-34
aggregation, and the async server's buffered commit.

Tolerances are float32 ones: the two frameworks order their sums
differently (matmul and convolution reductions, the loss mean), so results
agree to a few float32 ulps per operation, compounded over the steps.
"""
from _torch_oracle import jax_training_draws, rel_err  # noqa: I001  (alias first)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl.client import make_local_trainer as jax_trainer
from repro.fl import server as jax_server
from repro.fl.server import aggregate as jax_aggregate
from repro.models.small import get_small_model as jax_model
from repro.train.optimizer import make_optimizer as jax_optimizer
from repro_torch.fl.client import make_local_trainer
from repro_torch.fl import server
from repro_torch.fl.server import aggregate
from repro_torch.fl.sim import SimConfig
from repro_torch.models.small import get_small_model, params_from_jax
from repro_torch.train.optimizer import make_optimizer

_INPUTS = {
    "mnist": lambda rng, b: rng.normal(size=(b, 784)).astype(np.float32),
    "cifar10": lambda rng, b: rng.normal(size=(b, 32, 32, 3)).astype(np.float32),
    "sst2": lambda rng, b: rng.integers(0, 4000, (b, 32)).astype(np.int32),
}
_CLASSES = {"mnist": 10, "cifar10": 10, "sst2": 2}


def _batch(dataset, b=16, seed=0):
    rng = np.random.default_rng(seed)
    return _INPUTS[dataset](rng, b), rng.integers(0, _CLASSES[dataset], b).astype(np.int32)


def _jax_params(dataset, seed=0):
    return jax.tree_util.tree_map(np.asarray,
                                  jax_model(dataset).init(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("dataset", ["mnist", "cifar10", "sst2"])
def test_forward_and_loss_after_params_from_jax(dataset):
    """Logits and mean loss within 1e-4 relative (float32 reductions)."""
    x, y = _batch(dataset)
    jm, jp = jax_model(dataset), _jax_params(dataset)
    model = get_small_model(dataset)
    params = params_from_jax(jp)
    assert set(params) == {k for k, _ in model.named_parameters()}
    for k, p in model.named_parameters():
        assert params[k].shape == p.shape, k
    model.load_state_dict(params)
    with torch.no_grad():
        logits = model(torch.from_numpy(x))
        loss = model.loss_per_example(logits, torch.from_numpy(y)).mean()
        acc = model.correct(logits, torch.from_numpy(y)).mean()
    want_logits = np.asarray(jm.apply(jp, x))
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-4, atol=1e-5)
    assert rel_err(loss.item(), float(jm.loss(jp, x, y))) < 1e-5
    assert acc.item() == pytest.approx(float(jm.accuracy(jp, x, y)))


@pytest.mark.parametrize("dataset", ["mnist", "cifar10", "sst2"])
def test_init_params_law(dataset):
    """`init_params` draws every parameter with the JAX package's shapes and
    scale: zero biases, weights of the He-normal (or 0.1-normal) spread."""
    model = get_small_model(dataset)
    got = model.init_params(torch.Generator().manual_seed(0))
    want = params_from_jax(_jax_params(dataset))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == want[k].shape, k
        if k.endswith("bias"):
            assert not got[k].any()
        else:
            assert got[k].std().item() == pytest.approx(want[k].std().item(), rel=0.15)


@pytest.mark.parametrize("name,lr", [("sgd", 0.01), ("adam", 0.001)])
def test_optimizer_steps_match(name, lr):
    rng = np.random.default_rng(1)
    p = {"a": rng.normal(size=(5, 3)).astype(np.float32),
         "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
             for _ in range(3)]
    jopt, opt = jax_optimizer(name, lr), make_optimizer(name, lr)
    jp, tp = dict(p), {k: torch.from_numpy(v) for k, v in p.items()}
    js, ts = jopt.init(jp), opt.init(tp)
    for g in grads:
        ju, js = jopt.update(g, js, jp)
        jp = {k: jp[k] + ju[k] for k in jp}
        tu, ts = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        tp = {k: tp[k] + tu[k] for k in tp}
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dataset", ["mnist", "sst2"])
def test_local_trainer_with_jax_uniforms(dataset):
    """K slots x local steps of SGD from the same parameters on the same
    minibatches (the JAX package's uniforms, floor(u * n_valid) rows):
    1e-4 relative on every parameter after training."""
    cfg = SimConfig(dataset=dataset, n_subchannels=3, local_steps=2, batch=16)
    jp, next_u = jax_training_draws(cfg)
    u = next_u()
    # rebuild the JAX round keys for the reference trainer
    key = jax.random.PRNGKey(cfg.seed)
    key, _ = jax.random.split(key)
    _, k_round = jax.random.split(key)
    keys = jax.random.split(k_round, cfg.n_subchannels)

    rng = np.random.default_rng(2)
    x = np.stack([_INPUTS[dataset](rng, 20) for _ in range(3)])
    y = rng.integers(0, _CLASSES[dataset], (3, 20)).astype(np.int32)
    m = np.zeros((3, 20), np.float32)
    for i, nv in enumerate((20, 7, 13)):
        m[i, :nv] = 1.0
    jm = jax_model(dataset)
    want = jax_trainer(jm.loss, jax_optimizer("sgd", 0.05), batch_size=16, local_steps=2,
                       loss_per_example=jm.loss_per_example)(jp, x, y, m, keys)
    model = get_small_model(dataset)
    got = make_local_trainer(model, make_optimizer("sgd", 0.05), batch_size=16,
                             local_steps=2)(
        params_from_jax(jp), torch.from_numpy(x), torch.from_numpy(y),
        torch.from_numpy(m), torch.from_numpy(u))
    assert all(v.shape[0] == 3 for v in got.values())
    # compare leaf by leaf, in the JAX layout (dense w is (in, out) there)
    for layer, leaves in want.items():
        if not isinstance(leaves, dict):
            np.testing.assert_allclose(got[f"{layer}.weight"].numpy(),
                                       np.asarray(leaves), rtol=1e-4, atol=1e-6)
            continue
        for leaf, arr in leaves.items():
            g = got[f"{layer}.{'bias' if leaf == 'b' else 'weight'}"].numpy()
            if leaf != "b":
                g = np.swapaxes(g, 1, 2)
            np.testing.assert_allclose(g, np.asarray(arr), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("weights", [[3.0, 0.0, 5.0], [0.0, 0.0, 0.0]])
def test_aggregate_matches(weights):
    rng = np.random.default_rng(3)
    g = {"w": rng.normal(size=(4, 2)).astype(np.float32)}
    c = {"w": rng.normal(size=(3, 4, 2)).astype(np.float32)}
    w = np.asarray(weights, np.float32)
    want = np.asarray(jax_aggregate(g, c, jnp.asarray(w))["w"])
    got = aggregate({"w": torch.from_numpy(g["w"])}, {"w": torch.from_numpy(c["w"])},
                    torch.from_numpy(w))["w"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if not w.any():
        np.testing.assert_array_equal(got, g["w"])


@pytest.mark.parametrize("server_lr", [1.0, 0.5])
@pytest.mark.parametrize("weights", [[3.0, 0.0, 5.0], [0.0, 0.0, 0.0]])
def test_aggregate_buffered_matches(weights, server_lr):
    """The buffered commit against the JAX package's, and its exact
    endpoints: m = 1 is bitwise `aggregate`, no commit is bitwise identity."""
    rng = np.random.default_rng(4)
    g = {"w": rng.normal(size=(4, 2)).astype(np.float32)}
    c = {"w": rng.normal(size=(3, 4, 2)).astype(np.float32)}
    w = np.asarray(weights, np.float32)
    want = np.asarray(jax_server.aggregate_buffered(
        g, c, jnp.asarray(w), jnp.float32(server_lr))["w"])
    tg, tc, tw = ({"w": torch.from_numpy(g["w"])}, {"w": torch.from_numpy(c["w"])},
                  torch.from_numpy(w))
    got = server.aggregate_buffered(tg, tc, tw, torch.tensor(server_lr))["w"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    if server_lr == 1.0:
        torch.testing.assert_close(got, aggregate(tg, tc, tw)["w"], rtol=0, atol=0)
    if not w.any():
        np.testing.assert_array_equal(got.numpy(), g["w"])


def test_staleness_weight_and_presets():
    s = np.arange(6, dtype=np.int32)
    for exponent in (0.5, 0.0, 2.0):
        got = server.staleness_weight(torch.from_numpy(s), torch.tensor(exponent))
        want = np.asarray(jax_server.staleness_weight(jnp.asarray(s),
                                                      jnp.float32(exponent)))
        assert got.dtype == torch.float32 and got[0].item() == 1.0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert server.AGGREGATION_PRESETS.keys() == jax_server.AGGREGATION_PRESETS.keys()
    for name, spec in server.AGGREGATION_PRESETS.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            jax_server.AGGREGATION_PRESETS[name])
        assert spec.resolve_buffer(20, 4) == jax_server.AGGREGATION_PRESETS[
            name].resolve_buffer(20, 4)
    assert server.get_aggregation("sync") is None
    with pytest.raises(ValueError):
        server.get_aggregation("bogus")
    with pytest.raises(ValueError):
        server.AsyncAggregation(buffer=4).resolve_buffer(20, 4)
