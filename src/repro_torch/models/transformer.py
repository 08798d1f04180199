"""Model-zoo assembly (PyTorch copy of the JAX package's
`models/transformer.py`), for the layer kinds of its ten archs:
`LayerKind("attn", "dense")` (GQA + SwiGLU: qwen2-7b, stablelm-3b, yi-6b,
qwen1.5-110b; with M-RoPE, qwen2-vl-2b), `LayerKind("attn", "moe")` (GQA +
the MoE FFN of `models/moe.py`: granite-moe-3b-a800m),
`LayerKind("rwkv", "rwkv_cm")` (RWKV-6 time-mix + channel-mix: rwkv6-7b),
`LayerKind("mla", "dense" | "moe")` (MLA with a dense prefix, then MoE:
deepseek-v3-671b, with its MTP head), `LayerKind("mamba", "dense" |
"moe")` beside `("attn", "dense")` (the jamba hybrid's period of 8) and
`LayerKind("attn", "dense", cross=True)` (whisper-base's decoder layers,
each with a cross-attention to the encoder's output).  Any other kind
raises NotImplementedError.

The modality frontends are stubbed as in the JAX package: the audio
family gets precomputed encoder frames batch["enc_frames"] (B, Se, d),
which a non-causal encoder (`_encode_audio`: `n_encoder_layers` of GQA +
SwiGLU, then `enc_final_ln`) turns into the encoder output every decoder
layer cross-attends to; the VLM family gets patch embeddings
batch["image_embeds"] (B, n_patches, d) spliced over the first n_patches
token positions, and batch["mrope_pos"] (B, S, 3) M-RoPE positions.

The stage plan is the JAX package's: layers are grouped into stages, each
a periodic pattern of sublayer kinds repeated `repeats` times.  Where the
JAX package stacks a group's parameters on a leading `repeats` axis and
scans over it, the port keeps one parameter dict per layer in a list and
runs a Python loop over the layers:

    params["s{si}_l{li}"] = [layer_0, layer_1, ...]      (repeats entries)

The decode caches keep the JAX package's stage-stacked layout, e.g. for an
attention group {"k": (repeats, B, C, Hkv, Dh), "v": ..., "pos":
(repeats, C), "idx": (repeats,)}, for an MLA group {"c_kv": (repeats, B,
C, r), "k_pe": ..., "pos", "idx"}, for a Mamba group {"mamba": {"ssm":
(repeats, B, di, N), "conv": (repeats, B, kw - 1, di)}}, so they compare
leaf for leaf; each layer reads and writes its own slice in place
(`decode_step`).

The encoder keeps one parameter dict per layer too, params["encoder"]
(n_encoder_layers entries), beside params["enc_final_ln"].  An
encoder-decoder's cache carries the encoder output as cache["enc_out"],
which decode reads and never writes.

Modes:
  forward(..., mode="train")   -> (logits, aux), or (logits, aux,
                                  mtp_logits) with cfg.mtp; lm_loss trains on it
  forward(..., mode="prefill") -> (logits, aux, cache)  also seeds the caches
  decode_step(...)             -> (logits, cache)       one token, ring caches

aux is the MoE layers' summed load-balance loss (f32; 0 without them).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..kernels.rwkv6_wkv.ops import wkv6
from ..sharding import comm
from ..sharding.ctx import ShardCtx, meshed
from ..sharding.params import block_of
from ..sharding.partition import MODEL_AXIS, cache_model_dim, param_shardings
from . import tensor_parallel as TPM
from .attention import (cross_attn, cross_attn_init, gqa_decode, gqa_forward, gqa_init,
                        init_kv_cache, init_mla_cache, mla_decode, mla_forward, mla_init)
from .layers import (DTYPE, MetaGenerator, dense, dense_init, normal_bf16, rmsnorm,
                     rmsnorm_init, swiglu_init)
from .moe import moe_apply, moe_init
from .ssm import (init_mamba_state, init_rwkv6_state, mamba_forward, mamba_init,
                  rwkv6_channel_mix, rwkv6_init, rwkv6_time_mix, wkv6_scan_ref)

__all__ = [
    "LayerKind",
    "Stage",
    "stage_plan",
    "init_params",
    "param_shapes",
    "param_specs",
    "params_from_jax",
    "forward",
    "lm_loss",
    "decode_step",
    "init_cache",
    "clone_cache",
    "cache_len_for",
    "param_count",
    "vocab_parallel",
    "whole_logits",
]

ATTN_CHUNK = 1024  # query-chunked softmax ("ref") kicks in above 2x this seq length


def _wkv_impl(cfg: ArchConfig):
    """The WKV6 recurrence: the K5 wrapper (kernel on the card, plain
    version on the CPU) for "pallas", the plain loop for "ref".  Prefill and
    decode both take it."""
    return wkv6 if cfg.rwkv_wkv_impl == "pallas" else wkv6_scan_ref


# ==========================================================================
# Stage planning
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class LayerKind:
    mixer: str        # "attn" | "mla" | "rwkv" | "mamba"
    ffn: str          # "dense" | "moe" | "rwkv_cm"
    cross: bool = False

    @property
    def tag(self) -> str:
        return f"{self.mixer}-{self.ffn}" + ("-x" if self.cross else "")


@dataclasses.dataclass(frozen=True)
class Stage:
    pattern: tuple[LayerKind, ...]
    repeats: int


PORTED_KINDS = (LayerKind("attn", "dense"), LayerKind("attn", "moe"),
                LayerKind("rwkv", "rwkv_cm"), LayerKind("mla", "dense"),
                LayerKind("mla", "moe"), LayerKind("mamba", "dense"),
                LayerKind("mamba", "moe"), LayerKind("attn", "dense", cross=True))
ENCODER_KIND = LayerKind("attn", "dense")


def _kind_of(cfg: ArchConfig, i: int, *, decoder: bool) -> LayerKind:
    if cfg.family == "ssm":
        return LayerKind("rwkv", "rwkv_cm")
    if cfg.family == "hybrid":
        mixer = "attn" if cfg.is_attn_layer(i) else "mamba"
    elif cfg.use_mla:
        mixer = "mla"
    else:
        mixer = "attn"
    ffn = "moe" if cfg.is_moe_layer(i) else "dense"
    cross = decoder and cfg.is_encoder_decoder
    return LayerKind(mixer, ffn, cross)


def _smallest_period(kinds: list[LayerKind]) -> int:
    n = len(kinds)
    for p in range(1, n + 1):
        if n % p == 0 and all(kinds[i] == kinds[i % p] for i in range(n)):
            return p
    return n


def stage_plan(cfg: ArchConfig) -> list[Stage]:
    kinds = [_kind_of(cfg, i, decoder=True) for i in range(cfg.n_layers)]
    stages = []
    start = 0
    nd = cfg.n_dense_layers
    if nd > 0 and nd < cfg.n_layers:
        assert all(k == kinds[0] for k in kinds[:nd]), "dense prefix must be homogeneous"
        stages.append(Stage(pattern=(kinds[0],), repeats=nd))
        start = nd
    rest = kinds[start:]
    if rest:
        p = _smallest_period(rest)
        stages.append(Stage(pattern=tuple(rest[:p]), repeats=len(rest) // p))
    return stages


def _ported_plan(cfg: ArchConfig) -> list[Stage]:
    """The stage plan, or NotImplementedError for a layer kind still to port."""
    stages = stage_plan(cfg)
    for st in stages:
        for kind in st.pattern:
            if kind not in PORTED_KINDS:
                raise NotImplementedError(
                    f"{cfg.name}: layer kind {kind.tag!r} is still to port to PyTorch "
                    f"(ROADMAP.md, Queue 1: modules to port); the port runs "
                    f"{[k.tag for k in PORTED_KINDS]}")
    return stages


# ==========================================================================
# Parameters
# ==========================================================================

def _init_sublayer(gen: torch.Generator, cfg: ArchConfig, kind: LayerKind, ep_size: int = 1):
    p: dict[str, Any] = {"ln1": rmsnorm_init(cfg.d_model, gen.device)}
    if kind.mixer == "attn":
        p["attn"] = gqa_init(gen, cfg)
    elif kind.mixer == "mla":
        p["attn"] = mla_init(gen, cfg)
    elif kind.mixer == "mamba":
        p["mamba"] = mamba_init(gen, cfg)
    else:
        p["rwkv"] = rwkv6_init(gen, cfg)
    if kind.cross:
        p["ln_c"] = rmsnorm_init(cfg.d_model, gen.device)
        p["cross"] = cross_attn_init(gen, cfg)
    p["ln2"] = rmsnorm_init(cfg.d_model, gen.device)
    if kind.ffn == "dense":
        p["ffn"] = swiglu_init(gen, cfg.d_model, cfg.ffn_dense)
    elif kind.ffn == "moe":
        p["moe"] = moe_init(gen, cfg, ep_size=ep_size)
    return p


def init_params(cfg: ArchConfig, gen: torch.Generator, *, ep_size: int = 1):
    """Random parameters on `gen`'s device, drawn from `gen` with the JAX
    package's distributions (normal * scale stored bf16, f32 norms, RWKV
    w0 = -6 and u = 0; experts zero-probability padded to a multiple of
    the expert-parallel degree `ep_size`, as the JAX package pads them;
    with cfg.mtp the top-level `mtp_ln` and `mtp_head`; for an
    encoder-decoder the `encoder` layers and `enc_final_ln`).  The two
    frameworks draw different numbers from one seed: tests hand the JAX
    package's draws over with `params_from_jax`."""
    stages = _ported_plan(cfg)
    p: dict[str, Any] = {
        "embed": {"w": normal_bf16(gen, (cfg.vocab, cfg.d_model), 0.02)},
        "final_ln": rmsnorm_init(cfg.d_model, gen.device),
        "lm_head": dense_init(gen, cfg.d_model, cfg.vocab, scale=0.02),
    }
    for si, st in enumerate(stages):
        for li, kind in enumerate(st.pattern):
            p[f"s{si}_l{li}"] = [_init_sublayer(gen, cfg, kind, ep_size)
                                 for _ in range(st.repeats)]
    if cfg.is_encoder_decoder:
        p["encoder"] = [_init_sublayer(gen, cfg, ENCODER_KIND)
                        for _ in range(cfg.n_encoder_layers)]
        p["enc_final_ln"] = rmsnorm_init(cfg.d_model, gen.device)
    if cfg.mtp:
        p["mtp_ln"] = rmsnorm_init(cfg.d_model, gen.device)
        p["mtp_head"] = dense_init(gen, cfg.d_model, cfg.vocab, scale=0.02)
    return p


def param_shapes(cfg: ArchConfig, *, ep_size: int = 1):
    """`init_params`' exact tree (keys, per-layer lists, shapes, dtypes) as
    tensors on the meta device: nothing drawn, no storage (the port's
    counterpart of `jax.eval_shape(init_params)`)."""
    return init_params(cfg, MetaGenerator(), ep_size=ep_size)


@functools.lru_cache(maxsize=16)
def _param_specs(cfg: ArchConfig, mesh_items: tuple, ep_size: int) -> dict:
    return param_shardings(param_shapes(cfg, ep_size=ep_size), dict(mesh_items))


def param_specs(cfg: ArchConfig, mesh, ep_size: int) -> dict:
    """{path: spec} (`sharding.partition.param_shardings`) of
    `init_params(cfg, ep_size=ep_size)`'s tree at the shape of `mesh` (a
    `DeviceMesh` or {axis: size}), from the shapes alone."""
    from ..launch.mesh import mesh_shape
    return _param_specs(cfg, tuple(sorted(mesh_shape(mesh).items())), ep_size)


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # numpy's bf16 extension type: move the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_jax(cfg: ArchConfig, jax_params, device="cpu"):
    """The port's parameters from the JAX package's `init_params` tree (its
    leaves as numpy arrays, or anything np.asarray takes): each stacked
    `s{si}_l{li}` group is unstacked along its leading `repeats` axis into
    a list of per-layer dicts, and so is the `encoder` (n_encoder_layers);
    every other entry (embed, final_ln, lm_head, the MTP head's mtp_ln and
    mtp_head, enc_final_ln) is copied as it is."""
    groups = {f"s{si}_l{li}": st.repeats for si, st in enumerate(_ported_plan(cfg))
              for li in range(len(st.pattern))}
    groups["encoder"] = cfg.n_encoder_layers
    out: dict[str, Any] = {}
    for name, sub in jax_params.items():
        if name in groups:
            out[name] = [_tree_map(lambda a: _leaf_to_torch(np.asarray(a)[i], device), sub)
                         for i in range(groups[name])]
        else:
            out[name] = _tree_map(lambda a: _leaf_to_torch(a, device), sub)
    return out


def param_count(params) -> int:
    count = 0

    def add(t):
        nonlocal count
        count += t.numel()

    _tree_map(add, params)
    return count


# ==========================================================================
# Full-sequence forward (train / prefill)
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class _Extras:
    """What every sublayer of one forward pass or decode step shares, as
    the JAX package's `_Extras`: RoPE positions, M-RoPE positions (B, S, 3)
    or None, the encoder's output (B, Se, d) or None, the "ref" chunk; on
    a mesh the sharding context, whether the logits are vocab-parallel and
    the `model` axis the layers are partitioned over
    (`tensor_parallel.model_tp`: None on one model rank)."""
    positions: Any = None
    mrope_pos: Any = None
    enc_out: Any = None
    chunk: int = 0
    ctx: Any = None
    vocab_par: bool = False
    tp: Any = None


def _extras(cfg: ArchConfig, ctx, **kw) -> _Extras:
    if not meshed(ctx):
        return _Extras(ctx=ctx, **kw)
    specs = param_specs(cfg, ctx.mesh, ctx.ep_size)
    vocab_par = specs[("lm_head", "w")][-1] is not None and ctx.size(MODEL_AXIS) > 1
    return _Extras(ctx=ctx, vocab_par=vocab_par, tp=TPM.model_tp(ctx), **kw)


def _head(params, name: str, h, ex: _Extras):
    """The logits of the head `name` ("lm_head" / "mtp_head"): on a mesh
    whose rules shard the vocab, this rank's block of the vocab (V / model
    columns; h's gradient summed over the ranks' blocks in float32), else
    whole (the rules replicate it)."""
    if ex.vocab_par:
        return _VocabHead.apply(h, params[name]["w"], ex.ctx.group(MODEL_AXIS))
    return dense(params[name], h)


class _VocabHead(torch.autograd.Function):
    """h @ w for this rank's vocab block w (d, V / model) of a head, with
    h replicated over `model`: h's gradient is the ranks' partial products
    g @ w^T summed over `model` in float32 and rounded once (a bf16 sum of
    bf16-rounded partials would round twice), w's is h^T g."""

    @staticmethod
    def forward(ctx, h, w, group):
        ctx.save_for_backward(h, w)
        ctx.group = group
        return h @ w

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        dh = comm.all_reduce_(g.float() @ w.float().t(), ctx.group).to(h.dtype)
        dw = (h.reshape(-1, h.shape[-1]).t() @ g.reshape(-1, g.shape[-1])).to(w.dtype)
        return dh, dw, None


def vocab_parallel(cfg: ArchConfig, ctx) -> bool:
    """Whether `forward` / `decode_step` under `ctx` return this rank's
    vocab block of the logits: a mesh whose rules shard lm_head's vocab
    on a `model` axis of more than one rank (the JAX package's logits
    layout P(dp, None, "model")).  On one model rank the block is the
    whole vocab, and the plain head and log-softmax run."""
    return _extras(cfg, ctx).vocab_par


def whole_logits(cfg: ArchConfig, logits, ctx):
    """`logits` over the whole vocab: the ranks' vocab blocks gathered
    (no gradient) where they are vocab-parallel, else as they are."""
    if vocab_parallel(cfg, ctx):
        return comm.gather_(logits, ctx.group(MODEL_AXIS), logits.ndim - 1)
    return logits


def _sublayer_full(cfg, kind: LayerKind, p, x, ex: _Extras, want_cache: bool,
                   where: tuple = ()):
    """Returns (x, aux, cache contribution); aux is None without a MoE FFN.
    `p` is the sublayer's parameters at `where` in the tree (on a mesh
    this rank's blocks, which its partitioned layers compute with)."""
    tp = TPM.at(ex.tp, *where)
    cache: dict[str, Any] = {}
    aux = None
    h_in = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind.mixer == "attn":
        if want_cache:
            h, (k_, v_) = gqa_forward(p["attn"], cfg, h_in, positions=ex.positions,
                                      mrope_pos=ex.mrope_pos, chunk=ex.chunk, return_kv=True,
                                      ctx=ex.ctx, tp=TPM.at(tp, "attn"))
            cache = {"k": k_, "v": v_}
        else:
            h = gqa_forward(p["attn"], cfg, h_in, positions=ex.positions,
                            mrope_pos=ex.mrope_pos, chunk=ex.chunk, ctx=ex.ctx,
                            tp=TPM.at(tp, "attn"))
    elif kind.mixer == "mla":
        if want_cache:
            h, (ckv, kpe) = mla_forward(p["attn"], cfg, h_in, positions=ex.positions,
                                        chunk=ex.chunk, return_kv=True, ctx=ex.ctx,
                                        tp=TPM.at(tp, "attn"))
            cache = {"c_kv": ckv, "k_pe": kpe}
        else:
            h = mla_forward(p["attn"], cfg, h_in, positions=ex.positions, chunk=ex.chunk,
                            ctx=ex.ctx, tp=TPM.at(tp, "attn"))
    elif kind.mixer == "mamba":
        h, st = mamba_forward(p["mamba"], cfg, h_in, tp=TPM.at(tp, "mamba"))
        if want_cache:
            cache = {"mamba": st}
    else:
        st = init_rwkv6_state(cfg, x.shape[0], x.device,
                              heads=cfg.n_rwkv_heads // (tp.size if tp else 1))
        h, st = rwkv6_time_mix(p["rwkv"], cfg, h_in, st, wkv_impl=_wkv_impl(cfg),
                               tp=TPM.at(tp, "rwkv"))
        if want_cache:
            cache = {"rwkv": st}
    x = x + h
    if kind.cross:
        x = x + cross_attn(p["cross"], cfg, rmsnorm(p["ln_c"], x, cfg.norm_eps), ex.enc_out,
                           tp=TPM.at(tp, "cross"))
    if kind.ffn == "dense":
        x = x + TPM.swiglu(TPM.at(tp, "ffn"), p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps),
                           cfg.ffn_dense)
    elif kind.ffn == "moe":
        y, aux = moe_apply(p["moe"], cfg, rmsnorm(p["ln2"], x, cfg.norm_eps), ex.ctx)
        x = x + y
    else:
        cm_in = rmsnorm(p["ln2"], x, cfg.norm_eps)
        y, cm_prev = rwkv6_channel_mix(p["rwkv"], cfg, cm_in, torch.zeros_like(x[:, 0]),
                                       tp=TPM.at(tp, "rwkv"))
        x = x + y
        if want_cache:
            cache["cm_prev"] = cm_prev
    return x, aux, cache


def _sublayer_train(cfg, kind: LayerKind, p, x, ex: _Extras, where: tuple = ()):
    return _sublayer_full(cfg, kind, p, x, ex, False, where)[:2]


def _lookup(cfg: ArchConfig, params, tokens, ex: _Extras):
    """The embedding rows of `tokens`.  On a mesh whose rules shard the
    embedding's vocab (`tp`), vocab-parallel: each rank looks up the
    tokens in its block (zero rows elsewhere) and the rows are summed over
    `model` (one rank holds each, so the sum is exact)."""
    w = params["embed"]["w"]
    tokens = tokens.long()
    if ex.tp is None or w.shape[0] == cfg.vocab:
        return w[tokens]
    TPM.block(TPM.at(ex.tp, "embed"), w, 0, cfg.vocab, "w")
    v_loc = w.shape[0]
    local = tokens - ex.tp.rank * v_loc
    mine = (local >= 0) & (local < v_loc)
    rows = w[local.clamp(0, v_loc - 1)].masked_fill(~mine[..., None], 0)
    return comm.reduce_from(rows, ex.tp.group)


def _embed(cfg: ArchConfig, params, batch, ex: _Extras = _Extras()):
    """Token embeddings (`_lookup`); for the VLM family with
    batch["image_embeds"] (B, n_patches, d), those over the first
    n_patches positions."""
    h = _lookup(cfg, params, batch["tokens"], ex)
    if cfg.family == "vlm" and "image_embeds" in batch:
        if h.shape[1] < cfg.n_patches:
            raise ValueError(f"{cfg.name}: a sequence of {h.shape[1]} tokens is shorter than "
                             f"the image's n_patches={cfg.n_patches} patch embeddings")
        h = torch.cat([batch["image_embeds"].to(h.dtype), h[:, cfg.n_patches:]], dim=1)
    return h


def _encoder_layer(cfg: ArchConfig, p, x, ex: _Extras = _Extras(), where: tuple = ()):
    """One pre-norm encoder layer: non-causal self-attention, then SwiGLU
    (on a mesh partitioned over `model` as the decoder's)."""
    tp = TPM.at(ex.tp, *where)
    x = x + gqa_forward(p["attn"], cfg, rmsnorm(p["ln1"], x, cfg.norm_eps), causal=False,
                        tp=TPM.at(tp, "attn"))
    return x + TPM.swiglu(TPM.at(tp, "ffn"), p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps),
                          cfg.ffn_dense)


def _encode_audio(cfg: ArchConfig, params, frames, *, remat: bool = False,
                  ex: _Extras = _Extras()):
    """Whisper-style encoder over the stubbed conv-frontend frames (B, Se,
    d), cast to the weights' dtype: its layers (RoPE at arange(Se), no mask),
    then enc_final_ln."""
    x = frames.to(params["embed"]["w"].dtype)
    for i, p in enumerate(params["encoder"]):
        where = ("encoder", i)
        x = (checkpoint(_encoder_layer, cfg, p, x, ex, where, use_reentrant=False) if remat
             else _encoder_layer(cfg, p, x, ex, where))
    return rmsnorm(params["enc_final_ln"], x, cfg.norm_eps)


def forward(cfg: ArchConfig, params, batch, *, mode: str = "train", cache_headroom: int = 0,
            remat: bool = False, ctx: ShardCtx | None = None):
    """mode: "train" -> (logits, aux), with cfg.mtp (logits, aux,
    mtp_logits), the MTP head on the final normed hidden state; "prefill"
    -> (logits, aux, cache).

    batch["tokens"]: (B, S) integer tensor on the parameters' device; the
    audio family also takes batch["enc_frames"] (B, Se, d), the VLM family
    batch["image_embeds"] (B, n_patches, d) and batch["mrope_pos"] (B, S,
    3) (each optional: without them the tokens' embeddings and RoPE
    stand).
    cache_headroom: extra decode slots to allocate in the prefill cache
    (full-attention configs need >= the number of tokens to decode).
    remat (train mode): keep only each sublayer's input for the backward
    pass and recompute the sublayer there (torch.utils.checkpoint).
    ctx (`sharding.ctx.ShardCtx`): None or mesh=None is the single-device
    path.  On a mesh, `params` are this rank's blocks
    (`sharding.params.shard_tree`) and the batch is this rank's data
    shard.  The layers compute with the blocks as held
    (`models.tensor_parallel`): column- and row-parallel dense layers,
    head-parallel attention (or its projections gathered where the kv
    heads do not divide `model`) and RWKV, channel-parallel Mamba, the
    vocab-parallel embedding, the expert-parallel MoE; no weight moves.
    The residual stream is this rank's data shard, whole over `model`.
    The logits are this rank's vocab block, (B, S, V / model), where the
    rules shard the vocab (the JAX package's logits constraint P(dp, None,
    "model"); `vocab_parallel`, `whole_logits`), else whole.  The prefill cache is this rank's block of every leaf
    `sharding.partition.cache_shardings` shards over `model` (the cache
    length of "k" / "v" / "c_kv" / "k_pe", the heads or channels of the
    recurrent states)."""
    stages = _ported_plan(cfg)
    want_cache = mode == "prefill"
    ex0 = _extras(cfg, ctx)
    h = _embed(cfg, params, batch, ex0)
    b, s, _ = h.shape
    remat = remat and not want_cache
    ex = dataclasses.replace(
        ex0, positions=torch.arange(s, dtype=torch.int32, device=h.device)[None, :],
        mrope_pos=batch.get("mrope_pos"),
        enc_out=(_encode_audio(cfg, params, batch["enc_frames"], remat=remat, ex=ex0)
                 if cfg.is_encoder_decoder else None),
        chunk=ATTN_CHUNK if s > 2 * ATTN_CHUNK else 0)
    clen = cache_len_for(cfg, s + cache_headroom)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    all_caches = []
    for si, st in enumerate(stages):
        names = [f"s{si}_l{li}" for li in range(len(st.pattern))]
        got: list[list] = [[] for _ in st.pattern]
        for rep in range(st.repeats):
            for li, kind in enumerate(st.pattern):
                p, where = params[names[li]][rep], (names[li], rep)
                if remat:
                    h, a = checkpoint(_sublayer_train, cfg, kind, p, h, ex, where,
                                      use_reentrant=False)
                else:
                    h, a, c = _sublayer_full(cfg, kind, p, h, ex, want_cache, where)
                    if want_cache:
                        got[li].append(_prefill_entry(kind, c, s, clen, ex.ctx))
                if a is not None:
                    aux = aux + a
        all_caches.append(got)
    h = rmsnorm(params["final_ln"], h, cfg.norm_eps)
    logits = _head(params, "lm_head", h, ex)
    if mode == "train":
        if cfg.mtp:
            return logits, aux, _head(params, "mtp_head",
                                      rmsnorm(params["mtp_ln"], h, cfg.norm_eps), ex)
        return logits, aux
    return logits, aux, _assemble_prefill_cache(cfg, stages, all_caches, s, clen, ex.enc_out)


def _vocab_parallel_nll(logits, labels, ctx):
    """-log softmax(logits)[label] per token, (B, S) f32, from this rank's
    vocab block of the logits (B, S, V / model): the max over `model`
    (no gradient: it cancels), each rank's sum of exp and the label's logit
    where this rank holds it, summed over `model` (`comm.reduce_from`: each
    rank's backward takes its block's gradient)."""
    group = ctx.group(MODEL_AXIS)
    z = logits.float()
    v_loc = z.shape[-1]
    m = comm.all_reduce_max_(z.detach().amax(-1), group)
    sum_exp = comm.reduce_from(torch.exp(z - m[..., None]).sum(-1), group)
    local = labels - ctx.rank(MODEL_AXIS) * v_loc
    mine = (local >= 0) & (local < v_loc)
    picked = torch.gather(z, -1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
    z_label = comm.reduce_from(torch.where(mine, picked, torch.zeros_like(picked)), group)
    return torch.log(sum_exp) + m - z_label


def _nll(logits, labels, ctx, vocab_par: bool):
    """-log softmax(logits)[label] per token, (B, S) f32."""
    if vocab_par:
        return _vocab_parallel_nll(logits, labels, ctx)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[..., None])[..., 0]


def lm_loss(cfg: ArchConfig, params, batch, *, remat: bool = False,
            ctx: ShardCtx | None = None):
    """Selection-weighted causal-LM loss: the FL aggregation of eq. (34)
    folded into the loss, so one backward pass gives the weighted FedAvg
    gradient.  batch["fl_weights"] (B,) f32 carries alpha_n * beta_n * S_n
    per device-cohort (1s outside the FL context; rows of weight 0 add
    nothing).  With cfg.mtp the MTP head's NLL of the token after next
    (its logits at t against labels at t + 1) adds mtp_weight times its
    weighted mean.  Returns (loss + router_aux_coef * aux, {"aux": aux});
    aux is the MoE layers' summed load-balance loss (0 without MoE
    layers).

    With a meshed `ctx` the batch is this rank's data shard and the loss
    returned is this rank's share: its rows' weighted NLL over the whole
    batch's weight sum (all-reduced over the data axes), plus the aux term
    over the data shard count, so the shares sum over the data axes to the
    whole batch's loss and their gradients to its gradient.  Vocab-parallel
    logits (`vocab_parallel`) take the log-softmax from each rank's
    partials, combined over `model` (`_vocab_parallel_nll`); the MTP term
    likewise."""
    out = forward(cfg, params, batch, mode="train", remat=remat, ctx=ctx)
    logits, aux, mtp_logits = out[0], out[1], (out[2] if cfg.mtp else None)
    del out
    vocab_par = vocab_parallel(cfg, ctx)
    labels = batch["labels"].long()
    w = batch.get("fl_weights")
    if w is None:
        w = torch.ones(labels.shape[0], dtype=torch.float32, device=logits.device)
    nll = _nll(logits, labels, ctx, vocab_par)                           # (B, S)
    del logits
    wsum, n_shares = w.sum(), 1
    if meshed(ctx) and ctx.batch_sharded:
        wsum, n_shares = comm.all_reduce_(wsum.detach().clone(), ctx.dp_group()), ctx.dp_size
    wsum = torch.clamp(wsum, min=1e-9)
    loss = (nll.mean(dim=-1) * w).sum() / wsum
    if cfg.mtp:
        nll2 = _nll(mtp_logits[:, :-1], labels[:, 1:], ctx, vocab_par)
        loss = loss + cfg.mtp_weight * (nll2.mean(dim=-1) * w).sum() / wsum
    if n_shares > 1:
        return loss + cfg.router_aux_coef * aux / n_shares, {"aux": aux}
    return loss + cfg.router_aux_coef * aux, {"aux": aux}


# ==========================================================================
# Caches
# ==========================================================================

def cache_len_for(cfg: ArchConfig, seq_len: int) -> int:
    """Physical cache length: sliding-window archs cap at the window."""
    if cfg.sliding_window > 0:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def _stacked(t: torch.Tensor, repeats: int) -> torch.Tensor:
    """`repeats` independent copies of t on a new leading axis (each layer
    writes its own slice in place, so no stride-0 broadcast)."""
    return t[None].repeat((repeats,) + (1,) * t.ndim)


def _empty_sublayer_cache(cfg: ArchConfig, kind: LayerKind, batch: int, cache_len: int,
                          device):
    if kind.mixer == "attn":
        c: dict[str, Any] = init_kv_cache(cfg, batch, cache_len, device)
    elif kind.mixer == "mla":
        c = init_mla_cache(cfg, batch, cache_len, device)
    elif kind.mixer == "mamba":
        c = {"mamba": init_mamba_state(cfg, batch, device)}
    else:
        c = {"rwkv": init_rwkv6_state(cfg, batch, device)}
    if kind.ffn == "rwkv_cm":
        c["cm_prev"] = torch.zeros(batch, cfg.d_model, dtype=DTYPE, device=device)
    return c


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device, *, enc_out=None):
    """Empty ring-buffer caches for every layer, stacked per stage pattern
    slot; an encoder-decoder's also holds its encoder output `enc_out`
    (B, Se, d), which it needs."""
    clen = cache_len_for(cfg, seq_len)
    cache: dict[str, Any] = {}
    for si, st in enumerate(_ported_plan(cfg)):
        for li, kind in enumerate(st.pattern):
            one = _empty_sublayer_cache(cfg, kind, batch, clen, device)
            cache[f"s{si}_l{li}"] = _tree_map(lambda a: _stacked(a, st.repeats), one)
    if cfg.is_encoder_decoder:
        if enc_out is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder's decode cache needs the "
                             "encoder output (enc_out=)")
        cache["enc_out"] = enc_out
    return cache


def clone_cache(cache):
    """A copy of a decode cache that `decode_step` may update without
    touching the original."""
    return _tree_map(torch.clone, cache)


def _ring_from_prefill(seq_tensor, s, clen, seq_axis):
    """Place prefill entries for positions [0, s) into a clen-slot ring so
    that position p lands at slot p % clen (matching decode's write rule)."""
    if clen >= s:
        pad_shape = list(seq_tensor.shape)
        pad_shape[seq_axis] = clen - s
        pad = torch.zeros(pad_shape, dtype=seq_tensor.dtype, device=seq_tensor.device)
        return torch.cat([seq_tensor, pad], dim=seq_axis)
    taken = seq_tensor.narrow(seq_axis, s - clen, clen)
    return torch.roll(taken, s % clen, dims=seq_axis)


def _ring_positions(s, clen, repeats, device):
    if clen >= s:
        pos = torch.cat([torch.arange(s, dtype=torch.int32, device=device),
                         torch.full((clen - s,), -1, dtype=torch.int32, device=device)])
    else:
        pos = torch.roll(torch.arange(s - clen, s, dtype=torch.int32, device=device), s % clen)
    return _stacked(pos, repeats)


def _model_block(t: torch.Tensor, name: str, ctx) -> torch.Tensor:
    """This rank's block of one layer's whole cache leaf `name` along the
    dim `cache_shardings` puts on `model` (its own storage), or `t` where
    the rule keeps it whole or there is no mesh."""
    if not meshed(ctx):
        return t
    d = cache_model_dim(name, tuple(t.shape), ctx.size(MODEL_AXIS))
    if d is None:
        return t
    spec = tuple(MODEL_AXIS if i == d else None for i in range(t.ndim))
    return block_of(t, spec, ctx.mesh)


def _prefill_entry(kind: LayerKind, got: dict, s: int, clen: int, ctx) -> dict:
    """One layer's prefill cache contribution as its decode cache holds it:
    K/V (or MLA's latents) placed in the clen-slot ring, on a mesh this
    rank's block of its length (`_model_block`); the recurrent states as
    computed (on a mesh already this rank's heads or channels)."""
    if kind.mixer in ("attn", "mla"):
        names = ("k", "v") if kind.mixer == "attn" else ("c_kv", "k_pe")
        out: dict[str, Any] = {
            name: _model_block(_ring_from_prefill(got[name], s, clen, 1), name, ctx)
            for name in names}
    else:
        out = {kind.mixer: dict(got[kind.mixer])}
    if "cm_prev" in got:
        out["cm_prev"] = got["cm_prev"]
    return out


def _assemble_prefill_cache(cfg, stages, all_caches, s, clen, enc_out):
    """Stack the layers' prefill entries (`_prefill_entry`) per stage
    pattern slot into the decode caches, with the rings' positions and
    write index (and keep an encoder-decoder's encoder output)."""
    cache: dict[str, Any] = {}
    for si, st in enumerate(stages):
        for li, kind in enumerate(st.pattern):
            got = all_caches[si][li]
            c = _stack_entries(got)
            if kind.mixer in ("attn", "mla"):
                device = c["k" if kind.mixer == "attn" else "c_kv"].device
                c["pos"] = _ring_positions(s, clen, st.repeats, device)
                c["idx"] = torch.full((st.repeats,), s, dtype=torch.int32, device=device)
            cache[f"s{si}_l{li}"] = c
    if cfg.is_encoder_decoder:
        cache["enc_out"] = enc_out
    return cache


def _stack_entries(entries: list):
    """The layers' entries (dicts of tensors) stacked leaf by leaf on a new
    leading axis."""
    first = entries[0]
    if isinstance(first, dict):
        return {k: _stack_entries([e[k] for e in entries]) for k in first}
    return torch.stack(entries)


# ==========================================================================
# Decode
# ==========================================================================

def _write_states(held: dict, new: dict) -> None:
    """A recurrent mixer's new states written into the cache's views in
    place (on a mesh this rank's heads or channels, as held)."""
    for name, t in held.items():
        t.copy_(new[name])


def _sublayer_decode(cfg, kind: LayerKind, p, x, c, i: int, cur_pos, ex: _Extras,
                     where: tuple = ()):
    """Layer i of its group; reads and writes slice i of the group's cache
    `c` in place.  On a mesh the sublayer computes with this rank's blocks
    (`_sublayer_full`), the attention caches are read as this rank's block
    of the length (`attention.gqa_decode` / `mla_decode`), and the
    recurrent states are this rank's heads or channels, read and written
    where the cache holds them."""
    tp = TPM.at(ex.tp, *where)
    h_in = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind.mixer == "attn":
        view = {name: c[name][i] for name in ("k", "v", "pos", "idx")}
        h, _ = gqa_decode(p["attn"], cfg, h_in, view, cur_pos, mrope_pos=ex.mrope_pos,
                          ctx=ex.ctx, tp=TPM.at(tp, "attn"))
    elif kind.mixer == "mla":
        view = {name: c[name][i] for name in ("c_kv", "k_pe", "pos", "idx")}
        h, _ = mla_decode(p["attn"], cfg, h_in, view, cur_pos, ctx=ex.ctx,
                          tp=TPM.at(tp, "attn"))
    elif kind.mixer == "mamba":
        held = {"ssm": c["mamba"]["ssm"][i], "conv": c["mamba"]["conv"][i]}
        h, new = mamba_forward(p["mamba"], cfg, h_in, held, tp=TPM.at(tp, "mamba"))
        _write_states(held, new)
    else:
        held = {"wkv": c["rwkv"]["wkv"][i], "prev_tok": c["rwkv"]["prev_tok"][i]}
        h, new = rwkv6_time_mix(p["rwkv"], cfg, h_in, held, wkv_impl=_wkv_impl(cfg),
                                tp=TPM.at(tp, "rwkv"))
        _write_states(held, new)
    x = x + h
    if kind.cross:
        x = x + cross_attn(p["cross"], cfg, rmsnorm(p["ln_c"], x, cfg.norm_eps), ex.enc_out,
                           tp=TPM.at(tp, "cross"))
    if kind.ffn == "dense":
        x = x + TPM.swiglu(TPM.at(tp, "ffn"), p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps),
                           cfg.ffn_dense)
    elif kind.ffn == "moe":   # aux computed and dropped, as in the JAX package's decode
        x = x + moe_apply(p["moe"], cfg, rmsnorm(p["ln2"], x, cfg.norm_eps), ex.ctx)[0]
    else:
        cm_in = rmsnorm(p["ln2"], x, cfg.norm_eps)
        y, prev = rwkv6_channel_mix(p["rwkv"], cfg, cm_in, c["cm_prev"][i],
                                    tp=TPM.at(tp, "rwkv"))
        x = x + y
        c["cm_prev"][i].copy_(prev)
    return x


def decode_step(cfg: ArchConfig, params, batch, cache, ctx: ShardCtx | None = None):
    """One-token decode. batch: {"token": (B, 1) integer tensor, "pos": ()
    integer tensor, the global position, and with cfg.use_mrope
    "mrope_pos": (B, 1, 3), all on the parameters' device}.
    Updates `cache` IN PLACE (ring writes, write index, recurrent states;
    an encoder-decoder's cache["enc_out"] is read by every cross-attention
    and never written) and returns (logits (B, 1, V), cache); pass
    `clone_cache(cache)` to keep the old one.  A meshed `ctx` works as in
    `forward`: this rank's parameter blocks and batch shard, the layers
    partitioned as there (the token's q, k and v heads gathered for
    attention over this rank's block of the cache), the cache in
    `forward`'s prefill layout (this rank's block of the length
    and of the recurrent states), and the logits this rank's vocab block
    (B, 1, V / model) where they are vocab-parallel."""
    cur_pos = batch["pos"]
    ex = _extras(cfg, ctx, mrope_pos=batch.get("mrope_pos"), enc_out=cache.get("enc_out"))
    h = _lookup(cfg, params, batch["token"], ex)
    for si, st in enumerate(_ported_plan(cfg)):
        for rep in range(st.repeats):
            for li, kind in enumerate(st.pattern):
                name = f"s{si}_l{li}"
                h = _sublayer_decode(cfg, kind, params[name][rep], h, cache[name], rep,
                                     cur_pos, ex, (name, rep))
    h = rmsnorm(params["final_ln"], h, cfg.norm_eps)
    return _head(params, "lm_head", h, ex), cache
