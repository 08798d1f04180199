"""Rank functions of tests/test_torch_multidevice.py: what each rank of a
(data=2, model=2) gloo world runs.  Spawned processes import this module
by name, so it imports torch and the port only (no JAX): the oracles are
computed by the test process, which hands inputs over as torch tensors
and takes results back as float64 numpy.
"""
from __future__ import annotations

import copy
import time

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import get_config
from repro_torch.launch.mesh import smoke_mesh
from repro_torch.launch.multidevice_demo import demo_ctx, leaf_gaps, shard_rows
from repro_torch.models import moe as TM
from repro_torch.models.attention import sharded_causal_attention
from repro_torch.models.transformer import forward, param_specs, whole_logits
from repro_torch.sharding.ctx import ShardCtx
from repro_torch.sharding.params import shard_tree
from repro_torch.sharding.partition import leaves_with_path
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.serve_step import make_prefill_step, make_serve_step
from repro_torch.train.train_step import make_grad_fn, make_train_step
from repro_torch.train.tree import tree_leaves, tree_unflatten

DATA, MODEL = 2, 2


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().astype(np.float64)


def _ctx(attn_shard: str = "auto", multi_pod: bool = False) -> ShardCtx:
    """(data=2, model=2), or with multi_pod (pod=2, data=1, model=2) whose
    batch axes are ("pod", "data"): the same ranks in the same places."""
    torch.set_num_threads(1)
    if multi_pod:
        mesh = init_device_mesh("cpu", (DATA, 1, MODEL), mesh_dim_names=("pod", "data", "model"))
        return ShardCtx(mesh=mesh, dp_axes=("pod", "data"), attn_shard=attn_shard)
    return ShardCtx(mesh=smoke_mesh(DATA, MODEL, "cpu"), attn_shard=attn_shard)


def moe_rank(rank, cfg, moe_p: dict, x: torch.Tensor, cot: torch.Tensor) -> dict:
    """The expert-parallel `moe_apply` on this rank's data shard with its
    experts: y, aux, the routes, and the gradients of <y, cot> + aux of
    the input, the router and this rank's experts (aux counted once over
    the data shards)."""
    ctx = _ctx()
    nl = moe_p["gate"].shape[0] // MODEL
    r = ctx.rank("model")
    p = {"router": {"w": moe_p["router"]["w"].clone().requires_grad_(True)}}
    for name in ("gate", "up", "down"):
        p[name] = moe_p[name][r * nl:(r + 1) * nl].clone().requires_grad_(True)
    x_l = shard_rows(x, ctx).clone().requires_grad_(True)
    y, aux = TM.moe_apply(p, cfg, x_l, ctx)
    # Each data shard adds its share of the one aux, as `lm_loss` does.
    (torch.sum(y.float() * shard_rows(cot, ctx)) + aux / DATA).backward()
    _, _, top_e = TM._route(x_l.reshape(-1, x.shape[-1]), p["router"]["w"], cfg.top_k)
    return {"y": _np(y), "aux": float(aux), "top_e": top_e.numpy(), "e_off": r * nl,
            "data": ctx.dp_rank, "model": r, "gx": _np(x_l.grad),
            "grouter": _np(p["router"]["w"].grad),
            **{f"g{name}": _np(p[name].grad) for name in ("gate", "up", "down")}}


def attn_rank(rank, qg, k, v, window: int, chunk: int, cot) -> dict:
    """`sharded_causal_attention` on this rank's data shard, and the
    gradients of <out, cot> of q, k and v."""
    ctx = _ctx("explicit")
    q_l, k_l, v_l = (shard_rows(t, ctx).clone().requires_grad_(True) for t in (qg, k, v))
    out = sharded_causal_attention(q_l, k_l, v_l, qg.shape[-1] ** -0.5, window, chunk, ctx)
    torch.sum(out * shard_rows(cot, ctx)).backward()
    return {"out": _np(out), "gq": _np(q_l.grad), "gk": _np(k_l.grad), "gv": _np(v_l.grad),
            "data": ctx.dp_rank}


def train_rank(rank, arch: str, params: dict, batch: dict, attn_shard: str,
               lr: float, multi_pod: bool = False) -> dict:
    """One meshed AdamW step on this rank's blocks, functional and donated
    (from one copy each): the metrics, this rank's blocks after the step
    and of the step's gradient (`make_grad_fn`, the step's first half;
    paths as `leaves_with_path` gives them), and whether the donated step
    gave the functional one's bits."""
    ctx = _ctx(attn_shard, multi_pod)
    cfg = get_config(arch)
    local = shard_tree(params, param_specs(cfg, ctx.mesh, MODEL), ctx.mesh)
    ex = {name: shard_rows(t, ctx) for name, t in batch.items()}
    grads = make_grad_fn(cfg, remat=False, ctx=ctx)(local, ex)[0]
    opt = make_optimizer("adamw", lr)
    outs = {}
    for donate in (False, True):
        p0 = copy.deepcopy(local)
        step = make_train_step(cfg, opt, remat=False, donate=donate, ctx=ctx)
        outs[donate] = step(p0, opt.init(p0), ex)
    bitwise = all(torch.equal(a, b) for (_, a), (_, b) in
                  zip(leaves_with_path(outs[False][:2]), leaves_with_path(outs[True][:2])))
    bitwise &= all(torch.equal(outs[False][2][k], outs[True][2][k]) for k in outs[False][2])
    new, _, m = outs[True]
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "aux": float(m["aux"]), "donated_bitwise": bool(bitwise),
            "params": {path: _np(t) for path, t in leaves_with_path(new)},
            "grads": {path: _np(g) for (path, _), g in zip(leaves_with_path(local), grads)}}


def grad_rank(rank, cfg, params: dict, batch: dict, want: list, data: int,
              model: int) -> dict:
    """The meshed gradient (`make_grad_fn`, attn_shard="explicit") on this
    rank's blocks and data shard of a (data, model) mesh: the whole
    batch's loss, the gradient norm, and each leaf's
    ||g - want|| / ||want|| against this rank's blocks of `want` (whole
    leaves in `tree_leaves` order)."""
    torch.set_num_threads(1)
    b, s = batch["tokens"].shape
    ctx = demo_ctx(data, model, b, s, "explicit", "cpu")
    specs = param_specs(cfg, ctx.mesh, model)
    got, m = make_grad_fn(cfg, remat=False, ctx=ctx)(
        shard_tree(params, specs, ctx.mesh), {k: shard_rows(v, ctx) for k, v in batch.items()})
    want = tree_leaves(shard_tree(tree_unflatten(params, want), specs, ctx.mesh))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "gaps": leaf_gaps(got, want)}


def tp_rank(rank, meshes: list, cases: list) -> list:
    """For each (data, model) of `meshes`, each case {"cfg", "params"
    (whole), "batch", "tokens", "prompt", "n_new", "attn_shard",
    "frontend" (the prefill's extra batch entries)} on this rank of the
    gloo world as that mesh, the layers partitioned over `model`: the
    meshed gradient under remat (the whole batch's loss, the norm, this
    rank's gradient blocks by path), then a meshed prefill of this rank's
    rows of tokens[:, :prompt] and `n_new` greedy serve steps from its
    last token (the prefill's logits gathered over the vocab, each step's
    logits and token).  Returns [[case result, ...] per mesh]."""
    return [_tp_cases(data, model, cases) for data, model in meshes]


def _tp_cases(data: int, model: int, cases: list) -> list:
    torch.set_num_threads(1)
    out = []
    for c in cases:
        cfg, params, batch = c["cfg"], c["params"], c["batch"]
        b, s = batch["tokens"].shape
        ctx = demo_ctx(data, model, b, s, c["attn_shard"], "cpu")
        local = shard_tree(params, param_specs(cfg, ctx.mesh, model), ctx.mesh)
        grads, m = make_grad_fn(cfg, remat=True, ctx=ctx)(
            local, {k: shard_rows(v, ctx) for k, v in batch.items()})
        res = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "grads": {path: _np(g) for (path, _), g in zip(leaves_with_path(local), grads)},
               "data": ctx.dp_rank, "model": ctx.rank("model")}
        toks = shard_rows(c["tokens"], ctx)
        extra = {k: shard_rows(v, ctx) for k, v in c["frontend"].items()}
        with torch.no_grad():
            logits, _, cache = forward(cfg, local, {"tokens": toks[:, :c["prompt"]], **extra},
                                       mode="prefill", cache_headroom=c["n_new"], ctx=ctx)
            whole = whole_logits(cfg, logits, ctx)
        serve = make_serve_step(cfg, ctx)
        tok = whole[:, -1:].argmax(-1)
        steps, toks_out = [], []
        for d in range(c["n_new"]):
            tok, step_logits, cache = serve(local, {"token": tok,
                                                    "pos": torch.tensor(c["prompt"] + d)}, cache)
            steps.append(_np(step_logits[:, 0]))
            toks_out.append(tok[:, 0].numpy())
        res.update(prefill=_np(whole), decode=np.stack(steps, 1),
                   tokens=np.stack(toks_out, 1))
        out.append(res)
    return out


def serve_rank(rank, arch: str, params: dict, tokens: torch.Tensor, prompt: int) -> dict:
    """A meshed prefill of this rank's rows of tokens[:, :prompt], then
    teacher-forced steps of the meshed serve step over the rest: the
    prefill's logits (gathered over the vocab), every step's logits and
    greedy token, and this rank's cache leaves after the prefill and after
    the last step (paths as `leaves_with_path` gives them)."""
    ctx = _ctx("explicit")
    cfg = get_config(arch)
    local = shard_tree(params, param_specs(cfg, ctx.mesh, MODEL), ctx.mesh)
    toks = shard_rows(tokens, ctx)
    n_new = toks.shape[1] - prompt
    logits, _, cache = forward(cfg, local, {"tokens": toks[:, :prompt]}, mode="prefill",
                               cache_headroom=n_new, ctx=ctx)
    prefill = _np(whole_logits(cfg, logits, ctx))
    last, cache_last = make_prefill_step(cfg, cache_headroom=n_new, ctx=ctx)(
        local, {"tokens": toks[:, :prompt]})
    assert torch.equal(last, whole_logits(cfg, logits, ctx)[:, -1:])
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(leaves_with_path(cache), leaves_with_path(cache_last)))
    cache0 = {path: _np(t) for path, t in leaves_with_path(cache)}
    serve = make_serve_step(cfg, ctx)
    steps, toks_out = [], []
    for d in range(n_new):
        tok, got, cache = serve(local, {"token": toks[:, prompt + d:prompt + d + 1],
                                        "pos": torch.tensor(prompt + d)}, cache)
        steps.append(_np(got[:, 0]))
        toks_out.append(tok[:, 0].numpy())
    return {"prefill": prefill, "decode": np.stack(steps, 1), "tokens": np.stack(toks_out, 1),
            "cache0": cache0, "cache": {path: _np(t) for path, t in leaves_with_path(cache)},
            "data": ctx.dp_rank, "model": ctx.rank("model")}


def count_collectives(cfg, ctx, device) -> dict:
    """The collectives (`step_analysis.CollectiveBytes.calls`) of one
    meshed train step (AdamW, remat, donated), one prefill (batch 4, 16
    tokens, 4 free slots) and one serve step on its cache, at `cfg`'s
    shapes, on this rank's blocks: real ones on the CPU, or meta tensors
    under the fake process group ({"train" | "prefill" | "decode": {(op,
    site, bytes): calls}})."""
    from repro_torch.launch.step_analysis import CollectiveBytes
    from repro_torch.models.transformer import init_params, param_shapes
    from repro_torch.sharding.partition import batch_shardings
    from repro_torch.train.train_step import mesh_optimizer

    ep = ctx.ep_size
    if device == "meta":
        whole = param_shapes(cfg, ep_size=ep)
    else:
        whole = init_params(cfg, torch.Generator().manual_seed(0), ep_size=ep)
    params = shard_tree(whole, param_specs(cfg, ctx.mesh, ep), ctx.mesh)
    b, s = 4, 16
    tokens = torch.zeros(b, s + 1, dtype=torch.int32, device=device)
    if device != "meta":
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, (b, s + 1)).astype(np.int32))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "fl_weights": torch.ones(b, dtype=torch.float32, device=device)}
    batch = shard_tree(batch, batch_shardings(batch, ctx.mesh, ctx.dp_axes), ctx.mesh)
    out = {}
    opt = make_optimizer("adamw", 1e-3)
    state = mesh_optimizer(cfg, opt, ctx).init(params)
    step = make_train_step(cfg, opt, remat=True, donate=True, ctx=ctx)
    with CollectiveBytes() as counted:
        step(copy.deepcopy(params), state, batch)
    out["train"] = dict(counted.calls)
    with CollectiveBytes() as counted:
        _, cache = make_prefill_step(cfg, cache_headroom=4, ctx=ctx)(
            params, {"tokens": batch["tokens"]})
    out["prefill"] = dict(counted.calls)
    serve = make_serve_step(cfg, ctx)
    with CollectiveBytes() as counted:
        serve(params, {"token": batch["tokens"][:, :1],
                       "pos": torch.tensor(s, dtype=torch.int32, device=device)}, cache)
    out["decode"] = dict(counted.calls)
    return out


def collectives_rank(rank, arch: str) -> dict:
    """`count_collectives` on this rank of a real (data=2, model=2) gloo
    world."""
    return count_collectives(get_config(arch), _ctx("auto"), "cpu")


def adafactor_rank(rank, arch: str, params: dict, batch: dict, lr: float,
                   steps: int) -> dict:
    """`steps` meshed Adafactor steps (`make_train_step(ctx=)`, its state
    from `mesh_optimizer`) on this rank's blocks and data shard: the
    blocks and the state's leaves after them, and the metrics."""
    from repro_torch.train.train_step import mesh_optimizer

    ctx = _ctx("explicit")
    cfg = get_config(arch)
    local = shard_tree(params, param_specs(cfg, ctx.mesh, MODEL), ctx.mesh)
    ex = {name: shard_rows(t, ctx) for name, t in batch.items()}
    opt = make_optimizer("adafactor", lr)
    state = mesh_optimizer(cfg, opt, ctx).init(local)
    step = make_train_step(cfg, opt, remat=False, ctx=ctx)
    losses = []
    for _ in range(steps):
        local, state, m = step(local, state, ex)
        losses.append(float(m["loss"]))
    return {"params": {path: _np(t) for path, t in leaves_with_path(local)},
            "state": {path: _np(t) for path, t in leaves_with_path(state)},
            "losses": losses, "data": ctx.dp_rank, "model": ctx.rank("model")}


def adafactor_donate_rank(rank, cases: list, data: int, model: int, lr: float, steps: int,
                          chunk: int | None = None) -> list:
    """For each case (arch, whole params, whole batch), `steps` meshed
    Adafactor steps (`make_train_step(ctx=)`, its state from
    `mesh_optimizer`) on this rank's blocks and data shard of a (data,
    model) mesh, functional and donated from one copy each, each under
    `CollectiveBytes`; `chunk` (if given) the chunk bound
    (`optimizer.CHUNK_ELEMENTS`).  Per case: whether the donated steps gave
    the functional steps' bits (every block, both moments, the count, the
    metrics), the number of blocks the steps moved, and each form's
    collectives ({(op, site, bytes): calls})."""
    from repro_torch.launch.step_analysis import CollectiveBytes
    from repro_torch.train import optimizer as TO
    from repro_torch.train.train_step import mesh_optimizer

    torch.set_num_threads(1)
    if chunk is not None:
        TO.CHUNK_ELEMENTS = chunk
    out = []
    for arch, params, batch in cases:
        cfg = get_config(arch)
        b, s = batch["tokens"].shape
        ctx = demo_ctx(data, model, b, s, "explicit", "cpu")
        local = shard_tree(params, param_specs(cfg, ctx.mesh, model), ctx.mesh)
        ex = {name: shard_rows(t, ctx) for name, t in batch.items()}
        opt = make_optimizer("adafactor", lr)
        runs, calls = {}, {}
        for donate in (False, True):
            p = copy.deepcopy(local)
            state = mesh_optimizer(cfg, opt, ctx).init(p)
            step = make_train_step(cfg, opt, remat=False, donate=donate, ctx=ctx)
            metrics = []
            with CollectiveBytes() as counted:
                for _ in range(steps):
                    p, state, m = step(p, state, ex)
                    metrics.append(m)
            runs[donate], calls[donate] = (p, state, metrics), dict(counted.calls)
        (p0, s0, m0), (p1, s1, m1) = runs[False], runs[True]
        pairs = list(zip(leaves_with_path((p0, s0)), leaves_with_path((p1, s1)), strict=True))
        bitwise = all(a.dtype == b.dtype and torch.equal(a, b) for (_, a), (_, b) in pairs)
        bitwise &= all(torch.equal(x[k], y[k]) for x, y in zip(m0, m1) for k in x)
        moved = sum(not torch.equal(a, b) for (_, a), (_, b) in
                    zip(leaves_with_path(local), leaves_with_path(p1)))
        out.append({"bitwise": bool(bitwise), "moved": int(moved), "count": int(s1.count),
                    "calls": calls})
    return out


def hang_rank(rank, seconds: float):
    """Rank 1 sleeps past any sensible timeout; the others return."""
    if rank == 1:
        time.sleep(seconds)
    return rank


def fail_rank(rank):
    if rank == 1:
        raise ValueError("rank 1 failed on purpose")
    return rank
