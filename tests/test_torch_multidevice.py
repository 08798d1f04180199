"""The model across a mesh, on the CPU: four gloo ranks as (data=2, model=2).

Each test spawns a fresh world (`repro_torch.launch.multidevice_demo.spawn`:
a `FileStore` in a temporary directory, so xdist workers never share a
port; every rank joined with a timeout and killed on a failure) and runs a
rank function of tests/_torch_ranks.py.  The oracles:

  * the expert-parallel `moe_apply` against the JAX package's per-shard
    `_local_moe` (its shard_map body, no mesh: the JAX sharded model does
    not run under jax 0.9.0), one call per (data shard, model shard) with
    the capacity of the shard's tokens and its e_offset, summed over the
    model shards: routes exact (up to ties within 1e-6), y within 3 bf16
    ulp of its terms' scale plus 1e-3 (the tolerance of
    tests/test_torch_moe.py, whose F.silu rounding it inherits) and 1e-5
    in float32; aux, the whole batch's, against `_local_moe` over every
    token within 1e-5; gradients (float32, dropless) against the port's
    unsharded `moe_apply` within 1e-5 of their scale;
  * `sharded_causal_attention` in its head-parallel branch, its
    sequence-parallel branch (at the query blocks' offsets, one-shot and
    chunked, with and without a window) and its fallback against the JAX
    `_full_attn` (float32, within 1e-5 of the scale), and its q, k, v
    gradients against the port's plain `_full_attn` (1e-5);
  * one meshed `make_train_step(ctx=)` step (AdamW, lr 1e-3) against the
    port's unsharded step: loss within 1e-5 relative, grad norm within
    1e-3 (a bf16 gradient leaf is rounded on each data shard before their
    sum; deepseek-v3-671b-smoke shows 4.2e-4, the others under 1e-4),
    parameters within 2.5 lr absolute (AdamW's first step moves a
    parameter by +-lr, so a gradient that changes sign between the two
    summation orders moves it 2 lr) and at least 99% of each leaf within
    one bf16 ulp, except a leaf whose unsharded bf16 gradient's signs are
    rounding noise (more than 1% of them not the float64 step's: the k
    biases, `_signs_are_rounding_noise`), whose AdamW step is then a sign
    of noise: its meshed bf16 gradient is held instead within
    BF16_GRAD_RTOL of the float64 step's gradient's norm; the blocks of
    the two data replicas bitwise equal, and
    the donated step bitwise the functional one on the mesh; one case on
    (pod=2, data=1, model=2), the batch on ("pod", "data");
  * the meshed gradient (`make_grad_fn(ctx=)`) leaf by leaf against the
    unsharded one, on (2, 2) and (1, 4), dropless and with the MoE's
    capacity drops (against `multidevice_demo.shardwise_grads`), float32
    within 1e-5 of each leaf's norm and bf16 within 3e-2;
  * a meshed prefill and teacher-forced serve steps against the
    unsharded model (float32 copies, 1e-4 of the scale), each rank's
    cache leaves its `cache_shardings` block of the unsharded cache (the
    cache length, the Mamba channels and RWKV heads over `model`; a length
    `model` does not divide held whole);
  * `multidevice_demo.run(steps=4)` on (2, 2) lowers the loss.
"""
from _torch_oracle import bf16_ulp  # noqa: I001  (alias first)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing import ProcessRaisedException

import _torch_ranks as R
from repro.configs import get_config as jax_get_config
from repro.models import attention as JA
from repro.models import moe as JM
from repro_torch.configs import get_config
from repro_torch.launch import multidevice_demo
from repro_torch.launch.multidevice_demo import spawn
from repro_torch.models import attention as TA
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.sharding import partition as TP
from repro_torch.sharding.params import join_blocks, paired
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import make_grad_fn, make_train_step

WORLD = R.DATA * R.MODEL
TIMEOUT = 600
MOE_ARCH = "granite-moe-3b-a800m-smoke"
Y_FSILU_ULPS, Y_BF16_ATOL, Y_F32_ATOL, AUX_RTOL, GRAD_RTOL = 3, 1e-3, 1e-5, 1e-5, 1e-5
ATTN_RTOL = 1e-5
LR = 1e-3
LOSS_RTOL, GNORM_RTOL, PARAM_ATOL = 1e-5, 1e-3, 2.5 * LR
BF16_GRAD_RTOL = 3e-2           # a bf16 gradient leaf, as GRAD_CASES' bf16 case


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f64(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _torch(a) -> torch.Tensor:
    return TT._leaf_to_torch(np.asarray(a), "cpu")


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def test_spawn_kills_a_hung_rank_and_raises_a_failed_one():
    with pytest.raises(TimeoutError):
        spawn(R.hang_rank, WORLD, (300.0,), timeout=15)
    with pytest.raises(ProcessRaisedException, match="rank 1 failed on purpose"):
        spawn(R.fail_rank, WORLD, timeout=TIMEOUT)
    assert spawn(R.hang_rank, WORLD, (0.0,), timeout=TIMEOUT) == list(range(WORLD))


# --------------------------------------------------------------------------
# the expert-parallel MoE
# --------------------------------------------------------------------------

MOE_CASES = {"dropless": dict(shape=(4, 8), lean=0.0, n_experts=None),
             "drops": dict(shape=(4, 100), lean=1.0, n_experts=None),
             "padded": dict(shape=(4, 8), lean=0.0, n_experts=3)}


def _moe_layer(case, dtype_name):
    """(JAX cfg, port cfg, the first MoE layer's JAX params padded to the
    model axis, as jnp and as torch tensors)."""
    kw = {} if MOE_CASES[case]["n_experts"] is None else {
        "n_experts": MOE_CASES[case]["n_experts"]}
    jcfg = dataclasses.replace(jax_get_config(MOE_ARCH), **kw)
    tcfg = dataclasses.replace(get_config(MOE_ARCH), **kw)
    moe = jax.tree_util.tree_map(
        np.asarray, JM.moe_init(jax.random.PRNGKey(3), jcfg, ep_size=R.MODEL))
    if dtype_name == "f32":
        moe = jax.tree_util.tree_map(lambda a: a.astype(np.float32), moe)
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, moe), TT._tree_map(_torch, moe)


@pytest.mark.parametrize("dtype_name", ["bf16", "f32"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_ep_moe_matches_the_per_shard_jax_oracle(case, dtype_name):
    jcfg, tcfg, jm, tm = _moe_layer(case, dtype_name)
    b, s = MOE_CASES[case]["shape"]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32) + MOE_CASES[case]["lean"]
    cot = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype_name == "bf16" else jnp.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16 if dtype_name == "bf16" else torch.float32)
    outs = spawn(R.moe_rank, WORLD, (tcfg, tm, xt, torch.from_numpy(cot)), timeout=TIMEOUT)

    n_local = jm["gate"].shape[0] // R.MODEL
    rows = b // R.DATA
    t_local = rows * s
    cap = JM._capacity(t_local, jcfg)
    assert cap == TM._capacity(t_local, tcfg)
    dropped = 0
    for d in range(R.DATA):
        x_l = xj[d * rows:(d + 1) * rows].reshape(t_local, -1)
        parts = [JM._local_moe(x_l, jm["router"]["w"], *(jm[n][r * n_local:(r + 1) * n_local]
                                                          for n in ("gate", "up", "down")),
                               jcfg, cap, jnp.int32(r * n_local))[0] for r in range(R.MODEL)]
        want = sum(_f64(p) for p in parts)
        probs = np.asarray(jax.nn.softmax(x_l.astype(jnp.float32)
                                          @ jm["router"]["w"].astype(jnp.float32), -1))
        _, top_e = jax.lax.top_k(jnp.asarray(probs), jcfg.top_k)
        top_e = np.asarray(top_e)
        dropped += int((np.bincount(top_e.reshape(-1), minlength=jcfg.n_experts) > cap).sum())
        for o in outs:
            if o["data"] != d:
                continue
            differ = np.nonzero((o["top_e"] != top_e).any(-1))[0]
            for t in differ:       # a swapped expert ties with the k-th probability
                kth = np.sort(probs[t])[::-1][jcfg.top_k - 1]
                for e in set(o["top_e"][t]) ^ set(top_e[t]):
                    assert abs(probs[t, e] - kth) <= 1e-6 * kth, (t, e)
            got = o["y"].reshape(t_local, -1)
            diff = np.abs(got - want)
            if dtype_name == "f32":
                assert diff.max() <= Y_F32_ATOL, diff.max()
            else:
                scale = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                                   np.max([np.abs(_f64(p)) for p in parts], axis=0)
                                   .max(-1, keepdims=True))
                assert np.all(diff <= Y_FSILU_ULPS * bf16_ulp(scale) + Y_BF16_ATOL)
    assert (dropped > 0) == (case == "drops")
    # aux: the whole batch's routing statistics.
    aux_want = float(JM._local_moe(xj.reshape(b * s, -1), jm["router"]["w"], jm["gate"],
                                   jm["up"], jm["down"], jcfg, JM._capacity(b * s, jcfg),
                                   jnp.int32(0))[1])
    for o in outs:
        assert abs(o["aux"] - aux_want) <= AUX_RTOL * abs(aux_want)
    if dtype_name == "f32" and case != "drops":
        _check_moe_grads(outs, tcfg, tm, xt, torch.from_numpy(cot), n_local)


def _check_moe_grads(outs, tcfg, tm, xt, cot, n_local):
    """The ranks' gradients, reassembled, against the port's unsharded
    moe_apply on the whole batch (both dropless)."""
    p = TT._tree_map(lambda t: t.clone().requires_grad_(True), tm)
    x = xt.clone().requires_grad_(True)
    y, aux = TM.moe_apply(p, tcfg, x)
    (torch.sum(y.float() * cot) + aux).backward()
    rows = xt.shape[0] // R.DATA

    def close(got, want, what):
        want = _f64(want)
        assert np.abs(got - want).max() <= GRAD_RTOL * np.abs(want).max(), what

    for o in outs:
        close(o["gx"], x.grad[o["data"] * rows:(o["data"] + 1) * rows], "x")
    by = {(o["data"], o["model"]): o for o in outs}
    close(sum(by[(d, 0)]["grouter"] for d in range(R.DATA)), p["router"]["w"].grad, "router")
    for name in ("gate", "up", "down"):
        for r in range(R.MODEL):
            got = sum(by[(d, r)][f"g{name}"] for d in range(R.DATA))
            close(got, p[name].grad[r * n_local:(r + 1) * n_local], name)


# --------------------------------------------------------------------------
# sharded_causal_attention
# --------------------------------------------------------------------------

ATTN_CASES = {          # (Hkv, G, S, window, chunk): the branch the model axis picks
    "head": (2, 2, 16, 0, 0),
    "head-chunked-window": (2, 2, 16, 5, 4),
    "seq": (1, 4, 16, 0, 0),
    "seq-chunked": (1, 4, 16, 0, 2),
    "seq-window": (3, 2, 16, 6, 0),
    "fallback": (1, 2, 15, 0, 0),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_sharded_causal_attention_matches_jax_full_attn(case):
    hkv, g, s, window, chunk = ATTN_CASES[case]
    b, dh = 4, 8
    rng = np.random.default_rng(5)
    qg, k, v, cot = (rng.standard_normal(shape).astype(np.float32) for shape in
                     ((b, s, hkv, g, dh), (b, s, hkv, dh), (b, s, hkv, dh), (b, s, hkv, g, dh)))
    outs = spawn(R.attn_rank, WORLD, (torch.from_numpy(qg), torch.from_numpy(k),
                                      torch.from_numpy(v), window, chunk,
                                      torch.from_numpy(cot)), timeout=TIMEOUT)
    scale = dh ** -0.5
    if case.startswith("seq"):          # the JAX oracle at each query block's offset
        s_loc = s // R.MODEL
        want = np.concatenate([
            _f64(JA._full_attn(jnp.asarray(qg[:, i * s_loc:(i + 1) * s_loc]), jnp.asarray(k),
                               jnp.asarray(v), scale, window,
                               min(chunk, s_loc) if chunk else 0, i * s_loc))
            for i in range(R.MODEL)], axis=1)
    else:
        want = _f64(JA._full_attn(jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v), scale,
                                  window, chunk))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (qg, k, v))
    plain = TA._full_attn(qt, kt, vt, scale, window, chunk)
    torch.sum(plain * torch.from_numpy(cot)).backward()
    rows = b // R.DATA
    for o in outs:
        sl = slice(o["data"] * rows, (o["data"] + 1) * rows)
        assert np.abs(o["out"] - want[sl]).max() <= ATTN_RTOL * np.abs(want).max()
        for name, t in (("gq", qt), ("gk", kt), ("gv", vt)):
            ref = _f64(t.grad[sl])
            assert np.abs(o[name] - ref).max() <= ATTN_RTOL * np.abs(ref).max(), name


# --------------------------------------------------------------------------
# the meshed train step, and the demo
# --------------------------------------------------------------------------

TRAIN_CASES = [("granite-moe-3b-a800m-smoke", "explicit", False),
               ("granite-moe-3b-a800m-smoke", "auto", False),
               ("granite-moe-3b-a800m-smoke", "explicit", True),
               ("qwen2-7b-smoke", "explicit", False), ("deepseek-v3-671b-smoke", "explicit", False)]


def _assemble(outs, path, spec, key: str = "params"):
    """A leaf of `key` whole from the data-0 ranks' blocks (rank = d *
    MODEL + r), after checking the data-1 replicas hold the same bits."""
    for r in range(R.MODEL):
        np.testing.assert_array_equal(outs[r][key][path],
                                      outs[R.MODEL + r][key][path], err_msg=str(path))
    dims = [d for d, e in enumerate(spec) if e == "model"]
    if not dims:
        return outs[0][key][path]
    return join_blocks([torch.from_numpy(outs[r][key][path]) for r in range(R.MODEL)],
                       dims[0], paired(path)).numpy()


@pytest.mark.parametrize("arch,attn_shard,multi_pod", TRAIN_CASES,
                         ids=[f"{a.split('-')[0]}-{s}" + ("-pods" if m else "")
                              for a, s, m in TRAIN_CASES])
def test_meshed_train_step_matches_the_unsharded_step(arch, attn_shard, multi_pod):
    """On (data=2, model=2), or (pod=2, data=1, model=2) with the batch on
    ("pod", "data")."""
    cfg = get_config(arch)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), ep_size=R.MODEL)
    rng = np.random.default_rng(2)
    b, s = 4, 16
    tokens = rng.integers(0, cfg.vocab, (b, s + 1))
    w = rng.uniform(0.5, 2.0, b).astype(np.float32)
    w[1] = 0.0
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]), "labels": torch.from_numpy(tokens[:, 1:]),
             "fl_weights": torch.from_numpy(w)}
    outs = spawn(R.train_rank, WORLD, (arch, params, batch, attn_shard, LR, multi_pod),
                 timeout=TIMEOUT)
    assert all(o["donated_bitwise"] for o in outs)

    opt = make_optimizer("adamw", LR)
    want_p, _, m = make_train_step(cfg, opt, remat=False)(params, opt.init(params), batch)
    for o in outs:
        assert abs(o["loss"] - float(m["loss"])) <= LOSS_RTOL * abs(float(m["loss"]))
        assert abs(o["grad_norm"] - float(m["grad_norm"])) <= GNORM_RTOL * float(m["grad_norm"])
        assert abs(o["aux"] - float(m["aux"])) <= 1e-5 * max(abs(float(m["aux"])), 1e-6)
    specs = TT.param_specs(cfg, {"data": R.DATA, "model": R.MODEL}, R.MODEL)
    from repro_torch.sharding.partition import leaves_with_path
    n_sharded = 0
    for path, want in leaves_with_path(want_p):
        got = _assemble(outs, path, specs[path])
        want = _f64(want)
        assert got.shape == want.shape, path
        n_sharded += any(e is not None for e in specs[path])
        diff = np.abs(got - want)
        assert diff.max() <= PARAM_ATOL, (path, diff.max())
        near = diff <= bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        if near.mean() < 0.99:
            noise, g64 = _signs_are_rounding_noise(cfg, params, batch, path)
            assert noise, (path, near.mean())
            g = _assemble(outs, path, specs[path], "grads")
            gap = np.linalg.norm(g - g64) / np.linalg.norm(g64)
            assert gap <= BF16_GRAD_RTOL, (path, gap)
    assert n_sharded > 0


def _signs_are_rounding_noise(cfg, params, batch, path) -> tuple[bool, np.ndarray]:
    """Whether the unsharded bf16 gradient of the leaf at `path` gets the
    sign of more than 1% of its elements wrong, against the same step on
    float64 copies of the weights, and that float64 gradient.  AdamW's first step moves each element
    by about -lr * sign(g), so at such a leaf any other summation order
    (the partitioned layers round float32 partial sums where the
    unsharded bf16 GEMM rounds its own; one element in ~16 000 differs)
    moves more than 1% of it by 2 lr.  qwen2-7b-smoke's k biases: 76-80%
    of their bf16 signs are float64's, and 47-51% of their elements are
    off by more than half their value (the RoPE-rotated bias's gradient
    is a small sum of large terms), while their bf16 gradients stay within
    1.2e-2 / 1.8e-2 of the float64 one's norm (the meshed 1.2e-2 /
    2.4e-2; x86-64 CPU)."""
    from repro_torch.sharding.partition import leaves_with_path
    paths = [q for q, _ in leaves_with_path(params)]
    g16 = dict(zip(paths, make_grad_fn(cfg, remat=False)(params, batch)[0]))[path]
    p64 = TT._tree_map(lambda t: t.double(), params)
    g64 = dict(zip(paths, make_grad_fn(cfg, remat=False)(p64, batch)[0]))[path]
    noise = float((torch.sign(g16.double()) == torch.sign(g64)).double().mean()) < 0.99
    return noise, g64.numpy()


# ((data, model), seq, weights, reference, (loss, grad norm, gradient
# leaf) tolerances).  In float32 the meshed gradient is its reference up
# to summation order (measured: every leaf within 7e-7 of its norm).  At
# seq 4 the 8 x 4 tokens keep the MoE dropless both whole and per data
# shard; at seq 128 the experts drop copies, each data shard its own (its
# capacity is its own, the JAX package's rule), so the (2, 2) reference is
# `shardwise_grads` with the load-balance term off.  In bf16 a gradient
# leaf rounds on each data shard and each model rank sums its experts
# before the all-reduce: leaves within 1e-2 of their norm (one bf16 ulp is
# 3.9e-3 relative), the norm within 3.2e-4.
GRAD_CASES = [((2, 2), 4, torch.float32, "whole", (1e-5, 1e-5, 1e-5)),
              ((1, 4), 128, torch.float32, "whole", (1e-5, 1e-5, 1e-5)),
              ((2, 2), 128, torch.float32, "shards", (1e-5, 1e-5, 1e-5)),
              ((2, 2), 128, torch.bfloat16, "shards", (1e-5, 1e-3, 3e-2))]


@pytest.mark.parametrize("mesh,seq,dtype,ref,tols", GRAD_CASES,
                         ids=[f"{d}x{m}-s{s}-{str(t)[6:]}-{r}"
                              for (d, m), s, t, r, _ in GRAD_CASES])
def test_meshed_gradient_matches_its_reference(mesh, seq, dtype, ref, tols):
    """`make_grad_fn(ctx=)` on every rank's blocks against the unsharded
    gradient of the same weights on the same FL-weighted batch, leaf by
    leaf (a bound on the parameters after AdamW's first step holds for
    any gradient); with capacity drops the whole batch's gradient is
    shown to be another function."""
    data, model = mesh
    cfg = get_config(MOE_ARCH)
    if ref == "shards":
        cfg = dataclasses.replace(cfg, router_aux_coef=0.0)
    params = TT._tree_map(lambda t: t.to(dtype),
                          TT.init_params(cfg, torch.Generator().manual_seed(0), ep_size=model))
    batch = {k: torch.as_tensor(v)
             for k, v in next(multidevice_demo.fl_batches(cfg, 8, seq, 0))[0].items()}
    whole, m = make_grad_fn(cfg, remat=False)(params, batch)
    if ref == "shards":
        loss, want = multidevice_demo.shardwise_grads(cfg, params, batch, data)
        gnorm = float(torch.sqrt(sum(torch.sum(torch.square(g)) for g in want)))
        if dtype == torch.float32:
            assert max(multidevice_demo.leaf_gaps(whole, want)) > 100 * tols[2]
    else:
        want, loss, gnorm = whole, float(m["loss"]), float(m["grad_norm"])
    outs = spawn(R.grad_rank, WORLD, (cfg, params, batch, want, data, model), timeout=TIMEOUT)
    for o in outs:
        assert abs(o["loss"] - loss) <= tols[0] * abs(loss)
        assert abs(o["grad_norm"] - gnorm) <= tols[1] * gnorm
        assert max(o["gaps"]) <= tols[2], max(o["gaps"])


def _cache_block(leaf: np.ndarray, spec: tuple, data: int, model: int) -> np.ndarray:
    """The (data, model) rank's block of a whole cache leaf under its
    `cache_shardings` spec."""
    for dim, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        for axis in axes:
            n, r = (R.DATA, data) if axis == "data" else (R.MODEL, model)
            leaf = np.split(leaf, n, axis=dim)[r]
    return leaf


def _check_serve(outs, cfg, params, tokens, s, n_new, expect_sharded):
    """The ranks' meshed prefill and teacher-forced serve steps against
    the unsharded model: logits within 1e-4 of their scale, the greedy
    tokens the unsharded argmax wherever its top two are further apart
    than that, and each rank's cache leaves (after the prefill and after
    the last step) its `cache_shardings` block of the unsharded cache,
    within 1e-4 of the leaf's scale (positions and write index exact)."""
    want, _, cache = TT.forward(cfg, params, {"tokens": tokens[:, :s]}, mode="prefill",
                                cache_headroom=n_new)
    cache0 = TT.clone_cache(cache)
    steps = []
    for d in range(n_new):
        got, cache = TT.decode_step(cfg, params, {"token": tokens[:, s + d:s + d + 1],
                                                  "pos": torch.tensor(s + d)}, cache)
        steps.append(_f64(got[:, 0]))
    want, steps = _f64(want), np.stack(steps, 1)
    specs = TP.cache_shardings(cache, {"data": R.DATA, "model": R.MODEL}, ("data",))
    n_model_sharded = sum("model" in spec for spec in specs.values())
    assert (n_model_sharded > 0) == expect_sharded, specs
    rows = tokens.shape[0] // R.DATA
    top2 = np.sort(steps, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2e-4 * np.abs(steps).max()
    for o in outs:
        sl = slice(o["data"] * rows, (o["data"] + 1) * rows)
        assert np.abs(o["prefill"] - want[sl]).max() <= 1e-4 * np.abs(want).max()
        assert np.abs(o["decode"] - steps[sl]).max() <= 1e-4 * np.abs(steps).max()
        np.testing.assert_array_equal(o["tokens"][clear[sl]], steps[sl].argmax(-1)[clear[sl]])
        for key, whole in (("cache0", cache0), ("cache", cache)):
            for path, leaf in TP.leaves_with_path(whole):
                block = _cache_block(_f64(leaf), specs[path], o["data"], o["model"])
                got = o[key][path]
                assert got.shape == block.shape, (key, path)
                tol = 0 if path[-1] in ("pos", "idx") else 1e-4 * max(np.abs(block).max(), 1e-30)
                assert np.abs(got - block).max() <= tol, (key, path)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m-smoke", "deepseek-v3-671b-smoke"])
def test_meshed_prefill_and_decode_match_the_unsharded_model(arch):
    """A meshed prefill (attn_shard="explicit") and four teacher-forced
    serve steps (the MoE expert-parallel, the logits vocab-parallel, the
    GQA or MLA cache length 20 sharded over `model`) against the unsharded
    model, on float32 copies of the weights (in bf16 a route one ulp from a
    tie can flip): `_check_serve`."""
    cfg = get_config(arch)
    params = TT._tree_map(lambda t: t.float(),
                          TT.init_params(cfg, torch.Generator().manual_seed(0), ep_size=R.MODEL))
    b, s, n_new = 4, 16, 4
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (b, s + n_new)))
    outs = spawn(R.serve_rank, WORLD, (arch, params, tokens, s), timeout=TIMEOUT)
    _check_serve(outs, cfg, params, tokens, s, n_new, expect_sharded=True)


SERVE_STATE_CASES = [("granite-moe-3b-a800m-smoke", 3, False),
                     ("jamba-v0.1-52b-smoke", 4, True), ("rwkv6-7b-smoke", 2, True)]


@pytest.mark.parametrize("arch,n_new,sharded", SERVE_STATE_CASES,
                         ids=[a.split("-")[0] for a, _, _ in SERVE_STATE_CASES])
def test_meshed_serve_recurrent_states_and_a_whole_cache(arch, n_new, sharded):
    """The meshed serve steps where the cache holds recurrent states (the
    Mamba channels, the RWKV heads: blocks over `model`, gathered at use)
    and where `model` does not divide the cache length (granite's 19
    slots, held whole), against the unsharded model (`_check_serve`)."""
    cfg = get_config(arch)
    params = TT._tree_map(lambda t: t.float(),
                          TT.init_params(cfg, torch.Generator().manual_seed(0), ep_size=R.MODEL))
    b, s = 4, 16
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (b, s + n_new)))
    outs = spawn(R.serve_rank, WORLD, (arch, params, tokens, s), timeout=TIMEOUT)
    _check_serve(outs, cfg, params, tokens, s, n_new, expect_sharded=sharded)


def test_multidevice_demo_lowers_the_loss():
    losses = multidevice_demo.run(MOE_ARCH, steps=4, device="cpu", timeout=TIMEOUT)
    assert len(losses) == 4 and losses[-1] < losses[0]


def test_multidevice_demo_world_of_one():
    """A (1, 1) mesh in this process (a HashStore): the path the single
    card takes under NCCL."""
    losses = multidevice_demo.run(MOE_ARCH, steps=3, data=1, model=1, device="cpu")
    assert len(losses) == 3 and losses[-1] < losses[0]
