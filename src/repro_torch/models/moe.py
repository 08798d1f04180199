"""Mixture-of-Experts FFN (PyTorch copy of the JAX package's
`models/moe.py`): dropping top-k routing with sort-based capacity dispatch
into a fixed (E, C, d) buffer, dense expert GEMMs, and a gather-and-combine
back to the tokens.

Expert parallelism (`sharding.ctx.ShardCtx` with a mesh): the experts are zero-padded
to a multiple of the `model` axis (`pad_experts`; padded experts get no
router mass) and each model rank holds n_local = E_pad / ep of them, from
e_off = rank * n_local.  The tokens are the rank's data shard, replicated
over `model`; each model rank routes all of them (the router is
replicated), dispatches the copies that chose one of ITS experts, runs its
experts and returns a partial output; one all-reduce over `model` combines
them — the JAX package's shard_map with its psum, as explicit per-rank
code (`sharding.comm`: the input and router take `copy_to`, so their
gradients sum the ranks' partial ones; the combine is `reduce_from`).  The
capacity comes from the per-data-shard token count.  The load-balance aux
is the whole batch's: its expert counts and probability sums are
all-reduced over the data axes (the gradient flowing back to every
shard), then averaged over `model`.

Every shape is static, as in JAX, and no step reads the host: counts are a
`scatter_add_` (not `bincount`), masks multiply (no boolean indexing), so a
decode step on the card never synchronises.  The results follow JAX's:
  * the router is an f32 product (with TF32 off, torch's default: a TF32
    product keeps ~10 bits and moves routes), f32 softmax, ties in the
    top-k broken toward the lower expert id (`jax.lax.top_k`'s order) by a stable sort;
  * the T*k token copies are ordered by a stable sort on the expert id in
    `repeat(arange(T), k)` order, so capacity drops the same copies;
  * the combine weight is cast to the activation dtype before the
    multiply, and each token's k outputs are added one after another in
    increasing expert id, each sum rounded to the activation dtype: the
    order in which JAX's `.at[tok].add` visits them.  The adds are plain
    tensor adds, so two runs on the card give the same bits (`index_add_`
    uses atomics there and would not).

Capacity: C = T * top_k when that is <= 256 (decode, smoke tests: dropless),
else int(T * top_k * 1.25 / E) + 1; overflowing copies are dropped (their
contribution is 0).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..sharding import comm
from ..sharding.ctx import ShardCtx, meshed
from .layers import dense_init, normal_bf16, swiglu, swiglu_init

__all__ = ["moe_init", "moe_apply", "pad_experts", "CAPACITY_FACTOR"]

CAPACITY_FACTOR = 1.25


def pad_experts(n_experts: int, ep_size: int) -> int:
    return ((n_experts + ep_size - 1) // ep_size) * ep_size


def moe_init(gen: torch.Generator, cfg: ArchConfig, *, ep_size: int = 1):
    """The JAX package's distributions: router Normal * 0.02, experts
    Normal * sqrt(2 / (d + ff)), all stored bf16, the expert dim padded to
    a multiple of `ep_size` (`pad_experts`); shared experts (deepseek) one
    SwiGLU of width ff * n_shared_experts."""
    e_pad = pad_experts(cfg.n_experts, ep_size)
    ff, d = cfg.ffn_expert, cfg.d_model
    scale = (2.0 / (d + ff)) ** 0.5

    p: dict[str, Any] = {"router": dense_init(gen, d, cfg.n_experts, scale=0.02),
                         "gate": normal_bf16(gen, (e_pad, d, ff), scale),
                         "up": normal_bf16(gen, (e_pad, d, ff), scale),
                         "down": normal_bf16(gen, (e_pad, ff, d), scale)}
    if cfg.n_shared_experts > 0:
        p["shared"] = swiglu_init(gen, d, ff * cfg.n_shared_experts)
    return p


def _capacity(n_tokens: int, cfg: ArchConfig) -> int:
    """Expert capacity: dropless (T * top_k) for small token counts, else the
    capacity-factor bound."""
    if n_tokens * cfg.top_k <= 256:
        return n_tokens * cfg.top_k
    c = int(n_tokens * cfg.top_k * CAPACITY_FACTOR / cfg.n_experts) + 1
    return max(c, cfg.top_k)


def _route(x2d: torch.Tensor, router_w: torch.Tensor, k: int):
    """(probs (T, E) f32, top_p (T, k) renormalised, top_e (T, k) int64):
    the k largest probabilities, the lower expert id first on ties."""
    probs = torch.softmax(x2d.float() @ router_w.float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def _dispatch(top_e: torch.Tensor, n_local: int, capacity: int, e_offset=None):
    """The sort-based dispatch of the T*k copies: (order, keep, slot), with
    order the stable sort of the copies by expert id, keep whether the
    sorted copy fits its expert's capacity, and slot its row in the
    (n_local * capacity + 1, d) buffer (the last row takes the dropped).
    With `e_offset` (expert parallelism) ids are taken from it, and copies
    routed to another rank's experts sort last and are dropped here."""
    t, k = top_e.shape
    key = top_e.reshape(-1)
    if e_offset is not None:
        key = key - e_offset
        key = torch.where((key >= 0) & (key < n_local), key, torch.full_like(key, n_local))
    order = torch.argsort(key, stable=True)
    e_sorted = key[order]
    counts = torch.zeros(n_local + 1, dtype=torch.int64, device=key.device)
    counts.scatter_add_(0, key, torch.ones_like(key))
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts[:n_local], 0)])
    rank = torch.arange(t * k, device=key.device) - starts[torch.clamp(e_sorted, max=n_local)]
    keep = (e_sorted < n_local) & (rank < capacity)
    slot = torch.where(keep, e_sorted * capacity + rank,
                       torch.full_like(rank, n_local * capacity))
    return order, keep, slot


def _expert_counts(top_e: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """How many of the T*k copies chose each expert, (E,) f32."""
    flat_e = top_e.reshape(-1)
    frac = torch.zeros(cfg.n_experts, dtype=torch.float32, device=top_e.device)
    frac.scatter_add_(0, flat_e, torch.ones(flat_e.shape, dtype=torch.float32,
                                            device=top_e.device))
    return frac


def _experts(x2d, top_p, top_e, gate, up, down, cfg: ArchConfig, capacity: int,
             e_offset=None):
    """The T*k copies sorted by expert, scattered into (E * C) rows, through
    the experts held here, and combined back: y (T, d)."""
    t, d = x2d.shape
    n_local, k = gate.shape[0], cfg.top_k
    order, keep, slot = _dispatch(top_e, n_local, capacity, e_offset)
    tok_sorted = torch.div(order, k, rounding_mode="floor")   # repeat(arange(T), k)[order]
    w_sorted = top_p.reshape(-1)[order]
    gathered = x2d[tok_sorted] * keep[:, None].to(x2d.dtype)
    buf = x2d.new_zeros(n_local * capacity + 1, d)
    buf[slot] = gathered             # kept slots are distinct; the last row is discarded
    buf = buf[:-1].reshape(n_local, capacity, d)

    h = F.silu(torch.bmm(buf, gate)) * torch.bmm(buf, up)
    out = torch.bmm(h, down)                                          # (E, C, d)

    # ---- combine: gather by slot, weight, add each token's k in expert order.
    out_flat = torch.cat([out.reshape(n_local * capacity, d), out.new_zeros(1, d)])
    y_sorted = out_flat[slot] * (w_sorted * keep).to(out.dtype)[:, None]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    copies = y_sorted[inv].reshape(t, k, d)                       # token-major, top-k order
    by_expert = torch.argsort(top_e, dim=-1)                      # ids distinct in a row
    copies = torch.gather(copies, 1, by_expert[:, :, None].expand(t, k, d))
    y = copies[:, 0]
    for j in range(1, k):
        y = y + copies[:, j]
    return y


def _local_moe(x2d, router_w, gate, up, down, cfg: ArchConfig, capacity: int):
    """T tokens through the E experts held here.  x2d (T, d); gate/up/down
    (E, d|ff, ff|d).  Returns (y (T, d), aux ())."""
    t, k = x2d.shape[0], cfg.top_k
    probs, top_p, top_e = _route(x2d, router_w, k)
    # Load-balance aux (Switch-style): E * sum_e f_e * P_e, in f32.
    frac = _expert_counts(top_e, cfg) / (t * k)
    aux = cfg.n_experts * torch.sum(frac * probs.mean(0))
    return _experts(x2d, top_p, top_e, gate, up, down, cfg, capacity), aux


def _ep_moe(x2d, p, cfg: ArchConfig, ctx: ShardCtx):
    """The expert-parallel MoE on this rank: (y (T, d) combined over
    `model`, aux () of the whole batch averaged over `model`)."""
    group, ep = ctx.group(ctx.ep_axis), ctx.ep_size
    t, k = x2d.shape[0], cfg.top_k
    n_local = pad_experts(cfg.n_experts, ep) // ep
    e_off = ctx.rank(ctx.ep_axis) * n_local
    banks = [p[name] for name in ("gate", "up", "down")]
    if banks[0].shape[0] != n_local:
        raise ValueError(
            f"moe: this rank holds {banks[0].shape[0]} experts, expected its {n_local} of "
            f"{cfg.n_experts} padded to a multiple of ep={ep}: initialise with ep_size={ep} "
            "and keep this rank's block (`sharding.params.shard_tree`)")
    x_in = comm.copy_to(x2d, group)
    probs, top_p, top_e = _route(x_in, comm.copy_to(p["router"]["w"], group), k)
    counts, psum, n_tok = _expert_counts(top_e, cfg), probs.sum(0), t
    if ctx.batch_sharded:
        dp_group = ctx.dp_group()
        counts = comm.all_reduce_(counts, dp_group)
        psum = comm.all_reduce(psum, dp_group)
        n_tok = t * ctx.dp_size
    aux = cfg.n_experts * torch.sum(counts / (n_tok * k) * (psum / n_tok))
    y = _experts(x_in, top_p, top_e, *banks, cfg, _capacity(t, cfg), e_offset=e_off)
    return comm.reduce_from(y, group), comm.mean_from(aux, group)


def moe_apply(p, cfg: ArchConfig, x: torch.Tensor, ctx: ShardCtx | None = None):
    """x (B, S, d) -> (y (B, S, d), aux ()).  Shared experts (deepseek) are a
    plain dense SwiGLU added to the routed output.  With a meshed `ctx`, x
    is this rank's data shard and the experts are expert-parallel
    (`_ep_moe`); `p`'s expert banks are this rank's n_local experts."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    if not meshed(ctx):
        y2d, aux = _local_moe(x2d, p["router"]["w"], p["gate"], p["up"], p["down"], cfg,
                              _capacity(b * s, cfg))
    else:
        y2d, aux = _ep_moe(x2d, p, cfg, ctx)
    y = y2d.reshape(b, s, d)
    if "shared" in p:
        y = y + swiglu(p["shared"], x)
    return y, aux
