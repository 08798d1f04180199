"""The MoE FFN of the PyTorch port (`repro_torch.models.moe`) against the
JAX package's `models/moe.py` (its single-device path), on the CPU, on
granite-moe-3b-a800m-smoke's first MoE layer (4 experts, top-2, d 256,
ff 128) with the JAX package's `init_params` draws (`params_from_jax`).

Cases: dropless (T*k <= 256), with capacity drops (T*k > 256, inputs
leaning toward some experts so that at least one copy is dropped), and
with one shared expert; each in bf16 and on f32 copies of the draws.

Gates, with the gaps measured on an x86-64 CPU, one thread:
  * routing (top-k experts, the keep mask and the buffer slots): exactly
    JAX's, except where two probabilities lie within 1e-6 relative of each
    other (no such tie met: every case agrees exactly; the drops case
    drops 51 copies in both);
  * aux: 1e-6 relative (0 to 1.2e-7);
  * y in f32: 1e-5 absolute (4.8e-7 to 1.4e-6);
  * y in bf16, the port as it runs (F.silu, rounded once): 3 bf16 ulp,
    plus 1e-3 absolute, of the larger of |y| and the largest term that
    token's sum adds (a weighted expert output, or the shared SwiGLU's).
    Measured beyond the 1e-3: 2.74 (dropless), 2.94 (drops), 1.94 (shared)
    and 1.87 (`_local_moe` at capacity 8) ulp of that scale; against |y|
    alone up to 318 ulp, 0.047 absolute.  XLA expands bf16 `jax.nn.silu`
    into x * 1 / (1 + exp(-x)) with each operation rounded, which F.silu's
    one rounding misses by 1-2 ulp in ~30% of the hidden units; the down
    projection sums those into a few ulp of the terms, many ulp of a y
    whose terms cancel;
  * y in bf16 with SiLU rounded as XLA rounds it (`_xla_silu`, patched in
    by the test): 2 bf16 ulp plus 1e-3 absolute of |y| in the dropless and
    drops cases (0 and 0.74 ulp beyond the 1e-3), what remains being the
    GEMMs' summation order; the shared case, whose terms cancel (15.6 ulp
    of |y|), held to 2 ulp of the terms' scale (0.44).
"""
from _torch_oracle import bf16_ulp, f32, jax_llm_params, rel_max  # noqa: I001  (alias first)

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.transformer import param_count as jax_param_count
from repro_torch.configs import get_config
from repro_torch.models import layers
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

ARCH = "granite-moe-3b-a800m-smoke"
TIE_RTOL = 1e-6
AUX_RTOL, Y_F32_ATOL, Y_BF16_ULPS, Y_BF16_ATOL = 1e-6, 1e-5, 2, 1e-3
Y_FSILU_ULPS = 3           # bf16 y with F.silu, of the terms' scale (module docstring)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(**kw):
    return (dataclasses.replace(jax_get_config(ARCH), **kw),
            dataclasses.replace(get_config(ARCH), **kw))


def _layer(jcfg, tcfg, dtype_name, seed=1):
    """The first MoE layer's parameters: (JAX tree, port tree)."""
    p = jax_llm_params(jcfg, seed)
    moe = jax.tree_util.tree_map(lambda a: np.asarray(a)[0], p["s0_l0"]["moe"])
    if dtype_name == "f32":
        moe = jax.tree_util.tree_map(lambda a: a.astype(np.float32), moe)
    jm = jax.tree_util.tree_map(jnp.asarray, moe)
    tm = TT._tree_map(lambda a: TT._leaf_to_torch(a, "cpu"), moe)
    return jm, tm


def _x(shape, seed, dtype_name, lean=0.0):
    """Inputs from a numpy seed, in the layer's dtype; `lean` adds a common
    offset, which tilts every token's router logits the same way."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) + lean
    if dtype_name == "bf16":
        return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()
    return jnp.asarray(x), torch.from_numpy(x)


def _jax_routing(x2d, router_w, cfg, capacity):
    """The JAX package's routing and dispatch as `_local_moe` computes them
    (repro/models/moe.py, e_offset 0, all experts local): (probs, top_e,
    keep and slot per sorted copy, order)."""
    t, k, e = x2d.shape[0], cfg.top_k, cfg.n_experts
    probs = jax.nn.softmax(x2d.astype(jnp.float32) @ router_w.astype(jnp.float32), axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    key = top_e.reshape(-1)
    order = jnp.argsort(key, stable=True)
    e_sorted = key[order]
    counts = jnp.bincount(key, length=e + 1)[:e]
    starts = jnp.concatenate([jnp.zeros((1,), counts.dtype), jnp.cumsum(counts)])
    rank = jnp.arange(t * k) - starts[jnp.minimum(e_sorted, e)]
    keep = (e_sorted < e) & (rank < capacity)
    slot = jnp.where(keep, e_sorted * capacity + rank, e * capacity)
    return (np.asarray(probs), np.asarray(top_e), np.asarray(keep), np.asarray(slot),
            np.asarray(order))


def _copy_scale(x2d, tm, cfg):
    """Per token, the largest |w_j * expert_j(x)| of its k routed copies, in
    float64 from the port's weights (the scale of the terms y sums)."""
    x = f32(x2d)
    w = {n: f32(tm[n]) for n in ("gate", "up", "down")}
    logits = x @ f32(tm["router"]["w"])
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top_e = np.argsort(-p, -1, kind="stable")[:, :cfg.top_k]
    top_p = np.take_along_axis(p, top_e, -1)
    top_p /= top_p.sum(-1, keepdims=True)
    scale = np.zeros(len(x))
    for j in range(cfg.top_k):
        for e in range(cfg.n_experts):
            rows = np.nonzero(top_e[:, j] == e)[0]
            h = x[rows] @ w["gate"][e]
            out = (h / (1 + np.exp(-h)) * (x[rows] @ w["up"][e])) @ w["down"][e]
            scale[rows] = np.maximum(scale[rows], np.abs(top_p[rows, j, None] * out).max(-1))
    return scale


def _port_routing(x2d, tm, cfg, capacity):
    probs, _, top_e = TM._route(x2d, tm["router"]["w"], cfg.top_k)
    order, keep, slot = TM._dispatch(top_e, tm["gate"].shape[0], capacity)
    return probs.numpy(), top_e.numpy(), keep.numpy(), slot.numpy(), order.numpy()


def _assert_routing(got, want):
    """top_e exact except at ties within TIE_RTOL; with no disagreement, the
    sort order, keep mask and slots exact.  Returns the number of dropped
    copies."""
    probs, top_e = want[0], want[1]
    differ = np.nonzero((got[1] != top_e).any(-1))[0]
    for t in differ:
        ours, theirs = set(got[1][t]) - set(top_e[t]), set(top_e[t]) - set(got[1][t])
        kth = np.sort(probs[t])[::-1][len(top_e[t]) - 1]
        for e in ours | theirs:         # a swapped expert ties with the k-th probability
            assert abs(probs[t, e] - kth) <= TIE_RTOL * kth, (t, e)
    if differ.size == 0:
        for g, w, name in zip(got[2:], want[2:], ("keep", "slot", "order")):
            assert np.array_equal(g, w), name
    return int((~want[2]).sum())


def _check_y(yt, yj, dtype_name, scale=None, ulps=Y_BF16_ULPS):
    """f32: Y_F32_ATOL.  bf16: `ulps` bf16 ulp plus Y_BF16_ATOL of |y|, or,
    given `scale` (T,), of the larger of |y| and that token's scale."""
    a, b = f32(yt), f32(yj)
    diff = np.abs(a - b)
    if dtype_name == "f32":
        assert diff.max() <= Y_F32_ATOL
    else:
        mag = np.maximum(np.abs(a), np.abs(b))
        if scale is not None:
            mag = np.maximum(mag, scale.reshape(a.shape[:-1] + (1,)))
        assert np.all(diff <= ulps * bf16_ulp(mag) + Y_BF16_ATOL)


def _xla_silu(x):
    """SiLU as XLA expands bf16 `jax.nn.silu`: x * 1 / (1 + exp(-x)), each
    operation rounded to x's dtype."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def _moe_case(case, dtype_name):
    """(x2d_t, tm, tcfg, yt, yj, scale) of one case, after the routing, drop
    and aux checks."""
    kw = {"n_shared_experts": 1} if case == "shared" else {}
    jcfg, tcfg = _configs(**kw)
    jm, tm = _layer(jcfg, tcfg, dtype_name)
    b, s, lean = (2, 32, 0.0) if case != "drops" else (2, 200, 1.0)
    xj, xt = _x((b, s, jcfg.d_model), 7, dtype_name, lean)
    cap = TM._capacity(b * s, tcfg)
    assert cap == JM._capacity(b * s, jcfg)
    assert (b * s * tcfg.top_k <= 256) == (case != "drops")
    yj, auxj = JM.moe_apply(jm, jcfg, xj, JM.ShardCtx())
    yt, auxt = TM.moe_apply(tm, tcfg, xt)
    assert yt.dtype == xt.dtype and tuple(yt.shape) == yj.shape
    x2d_j, x2d_t = xj.reshape(b * s, -1), xt.reshape(b * s, -1)
    dropped = _assert_routing(_port_routing(x2d_t, tm, tcfg, cap),
                              _jax_routing(x2d_j, jm["router"]["w"], jcfg, cap))
    assert (dropped > 0) == (case == "drops"), dropped
    assert abs(float(auxt) - float(auxj)) <= AUX_RTOL * abs(float(auxj))
    scale = _copy_scale(x2d_t, tm, tcfg)
    if case == "shared":      # the shared SwiGLU's output adds to each token's terms
        sh = np.abs(f32(TM.swiglu(tm["shared"], xt))).reshape(b * s, -1).max(-1)
        scale = np.maximum(scale, sh)
    return yt, yj, scale


@pytest.mark.parametrize("dtype_name", ["bf16", "f32"])
@pytest.mark.parametrize("case", ["dropless", "drops", "shared"])
def test_moe_apply_matches_jax(case, dtype_name):
    """moe_apply against the JAX package's: routing and aux under the
    module's gates, the drops case dropping at least one copy (and the
    others none); y in f32 within Y_F32_ATOL, in bf16 within
    Y_FSILU_ULPS of the terms' scale (F.silu's rounding)."""
    yt, yj, scale = _moe_case(case, dtype_name)
    _check_y(yt, yj, dtype_name, scale, Y_FSILU_ULPS)


@pytest.mark.parametrize("case", ["dropless", "drops", "shared"])
def test_moe_apply_bf16_holds_two_ulp_with_xla_rounded_silu(case, monkeypatch):
    """With SiLU rounded as XLA rounds it (in the routed experts and the
    shared SwiGLU), the bf16 output holds 2 ulp plus 1e-3 of |y| in the
    dropless and drops cases: what is left is the GEMMs' summation order.
    The shared case is held to 2 ulp of the terms' scale instead (its terms
    cancel; 32 ulp of |y|)."""
    monkeypatch.setattr(TM, "F", types.SimpleNamespace(silu=_xla_silu))
    monkeypatch.setattr(layers, "F", types.SimpleNamespace(silu=_xla_silu))
    yt, yj, scale = _moe_case(case, "bf16")
    _check_y(yt, yj, "bf16", scale if case == "shared" else None, Y_BF16_ULPS)


def test_local_moe_matches_jax_at_a_given_capacity():
    """`_local_moe` with a capacity below the tokens' share (64 tokens,
    top-2, capacity 8 for 4 experts): drops in every expert, routing and y
    as JAX's `_local_moe`."""
    jcfg, tcfg = _configs()
    jm, tm = _layer(jcfg, tcfg, "bf16")
    xj, xt = _x((64, jcfg.d_model), 3, "bf16")
    args_j = (jm["router"]["w"], jm["gate"], jm["up"], jm["down"], jcfg, 8)
    yj, auxj = JM._local_moe(xj, *args_j, jnp.zeros((), jnp.int32))
    yt, auxt = TM._local_moe(xt, tm["router"]["w"], tm["gate"], tm["up"], tm["down"], tcfg, 8)
    dropped = _assert_routing(_port_routing(xt, tm, tcfg, 8),
                              _jax_routing(xj, jm["router"]["w"], jcfg, 8))
    assert dropped >= 64 * 2 - 4 * 8
    assert abs(float(auxt) - float(auxj)) <= AUX_RTOL * abs(float(auxj))
    _check_y(yt, yj, "bf16", _copy_scale(xt, tm, tcfg), Y_FSILU_ULPS)


def test_router_ties_go_to_the_lower_expert_id():
    """Experts 1 and 2 have equal router columns, so every token's second
    choice is a tie: both packages take expert 1 (jax.lax.top_k's order)."""
    jcfg, tcfg = _configs()
    jm, tm = _layer(jcfg, tcfg, "f32")
    rng = np.random.default_rng(4)
    v = rng.standard_normal(jcfg.d_model).astype(np.float32)
    w = np.stack([2 * v, v, v, -v], axis=1)
    x = rng.standard_normal((16, jcfg.d_model)).astype(np.float32)
    x *= np.sign(x @ v)[:, None]                           # x . v > 0: expert 0 first
    jm = dict(jm, router={"w": jnp.asarray(w)})
    tm = dict(tm, router={"w": torch.from_numpy(w)})
    probs, _, top_e = TM._route(torch.from_numpy(x), tm["router"]["w"], 2)
    assert torch.equal(probs[:, 1], probs[:, 2])
    assert top_e.tolist() == [[0, 1]] * 16
    want = _jax_routing(jnp.asarray(x), jm["router"]["w"], jcfg, 32)
    assert want[1].tolist() == [[0, 1]] * 16
    yj, _ = JM.moe_apply(jm, jcfg, jnp.asarray(x)[None], JM.ShardCtx())
    yt, _ = TM.moe_apply(tm, tcfg, torch.from_numpy(x)[None])
    _check_y(yt, yj, "f32", None)


@pytest.mark.parametrize("case", ["dropless", "drops"])
def test_combine_is_bitwise_repeatable(case):
    jcfg, tcfg = _configs()
    _, tm = _layer(jcfg, tcfg, "bf16")
    s = 32 if case == "dropless" else 200
    _, xt = _x((2, s, tcfg.d_model), 8, "bf16", 1.0 if case == "drops" else 0.0)
    y1, a1 = TM.moe_apply(tm, tcfg, xt)
    y2, a2 = TM.moe_apply(tm, tcfg, xt.clone())
    assert torch.equal(y1, y2) and torch.equal(a1, a2)


def test_moe_gradients_match_jax():
    """d(sum(y * r) + aux) / d(x, router, experts) on f32 copies, against
    jax.grad on the same: 1e-4 of each leaf's scale (through the sort-based
    dispatch, the renormalised top-k weights and the aux)."""
    jcfg, tcfg = _configs()
    jm, tm = _layer(jcfg, tcfg, "f32")
    xj, xt = _x((2, 16, jcfg.d_model), 9, "f32")
    r = np.random.default_rng(10).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)

    def jloss(p, x):
        y, aux = JM.moe_apply(p, jcfg, x, JM.ShardCtx())
        return jnp.sum(y * jnp.asarray(r)) + aux

    gj = jax.grad(jloss, argnums=(0, 1))(jm, xj)
    leaves = {"router": tm["router"]["w"], "gate": tm["gate"], "up": tm["up"],
              "down": tm["down"]}
    leaves = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    x_req = xt.clone().requires_grad_(True)
    p = {"router": {"w": leaves["router"]}, "gate": leaves["gate"], "up": leaves["up"],
         "down": leaves["down"]}
    y, aux = TM.moe_apply(p, tcfg, x_req)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    pairs = [(x_req.grad, gj[1]), (leaves["router"].grad, gj[0]["router"]["w"])]
    pairs += [(leaves[n].grad, gj[0][n]) for n in ("gate", "up", "down")]
    for got, want in pairs:
        got, want = f32(got), f32(want)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_ep_size_other_than_one_raises():
    """ep_size other than one pads the expert banks to a multiple of it, as
    the JAX package's `moe_init` pads them (shapes and dtypes leaf for leaf);
    nothing is refused."""
    cfg = get_config(ARCH)
    got = TM.moe_init(torch.Generator().manual_seed(0), cfg, ep_size=16)
    want = jax.eval_shape(lambda: JM.moe_init(jax.random.PRNGKey(0), cfg, ep_size=16))
    for name in ("gate", "up", "down"):
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        assert got[name].shape[0] == TM.pad_experts(cfg.n_experts, 16)
    assert tuple(got["router"]["w"].shape) == tuple(want["router"]["w"].shape)
    assert TM.pad_experts(40, 16) == JM.pad_experts(40, 16) == 48


# --------------------------------------------------------------------------
# the MoE in the model: a dense prefix, shared experts, parameter counts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["dense_prefix", "shared"])
def test_moe_model_variants_match_jax(variant):
    """A dense prefix before the MoE layers (deepseek's and jamba's plan:
    stages 1 x attn-dense, then 2 x attn-moe) and shared experts plan as
    the JAX package plans them, and their prefill logits and aux match it.
    Compared on f32 copies of the draws in both packages (logits 1e-4 of
    the scale, measured 1.0e-6 and 1.7e-6; aux 1e-6 relative, 1.2e-7): in
    bf16 the dense prefix's F.silu rounds its hidden units differently
    from XLA's, which moves 3 of the 48 tokens to other experts (0.31 of
    the scale on those rows), so a bf16 comparison would measure the
    routing's discontinuity, not the prefix's wiring."""
    kw = ({"n_layers": 3, "n_dense_layers": 1} if variant == "dense_prefix"
          else {"n_shared_experts": 1})
    jcfg, tcfg = _configs(**kw)
    plan = [([k.tag for k in st.pattern], st.repeats) for st in TT.stage_plan(tcfg)]
    assert plan == [([k.tag for k in st.pattern], st.repeats) for st in JT.stage_plan(jcfg)]
    if variant == "dense_prefix":
        assert plan == [(["attn-dense"], 1), (["attn-moe"], 2)]
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jax_llm_params(jcfg, 2))
    tp = TT.params_from_jax(tcfg, p)
    assert TT.param_count(tp) == jax_param_count(p)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 24)).astype(np.int32)
    jl, jaux, _ = JT.forward(jcfg, jax.tree_util.tree_map(jnp.asarray, p),
                             {"tokens": jnp.asarray(toks)}, mode="prefill", cache_headroom=2)
    tl, taux, _ = TT.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)}, mode="prefill",
                             cache_headroom=2)
    assert tl.dtype == torch.float32
    assert rel_max(tl, jl) < 1e-4
    assert float(taux) > 0 and abs(float(taux) - float(jaux)) <= AUX_RTOL * float(jaux)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "stablelm-3b", "yi-6b",
                                  "qwen1.5-110b", "deepseek-v3-671b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_param_count_matches_jax_from_shapes(arch, size):
    """param_count of the port's tree equals the JAX package's, both from
    shapes alone: jax.eval_shape of its init_params, the port's
    `param_shapes` (init_params on the meta device; qwen1.5-110b: 111 B
    parameters, deepseek-v3-671b: 671 952 965 632 with its MTP head, never
    allocated)."""
    name = arch if size == "full" else arch + "-smoke"
    jcfg, tcfg = jax_get_config(name), get_config(name)
    shapes = jax.eval_shape(lambda k: JT.init_params(jcfg, k), jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    tp = TT.param_shapes(tcfg)
    devices = set()
    TT._tree_map(lambda t: devices.add(t.device.type), tp)
    assert devices == {"meta"}
    assert TT.param_count(tp) == want
    if name == "deepseek-v3-671b":
        assert want == 671_952_965_632
