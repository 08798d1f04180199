"""Grouped-query attention, deepseek-style MLA and whisper-style
cross-attention (PyTorch copy of the JAX package's `models/attention.py`):
QKV bias, RoPE and
qwen2-VL's M-RoPE, sliding window, chunked softmax for long prefill,
non-causal (encoder) attention, the ring-buffer decode cache, and MLA's
low-rank latent KV cache with its decoupled RoPE key.

Grouped heads never materialize the repeated K/V: queries are reshaped to
(B, S, Hkv, G, Dh) and contracted against (B, S, Hkv, Dh) directly.

Caches (decode path) are ring buffers:
    {"k": (B, C, Hkv, Dh), "v": (B, C, Hkv, Dh), "pos": (C,) int32 global
     positions (-1 = empty), "idx": () int32 next write slot}
K is stored *with RoPE applied at its true position*, so decode never
re-rotates the cache.  Sliding-window configs simply allocate C = window.

MLA caches the latent instead: {"c_kv": (B, C, kv_lora_rank), "k_pe": (B,
C, qk_rope_dim) (rotated), "pos", "idx"}.

Unlike the JAX package's functional cache, `gqa_decode` and `mla_decode`
write the new token's entries, position and write index into the cache IN
PLACE (the cache is the decode step's largest state; a copy per step would
move all of it).  A caller that wants to keep the old cache passes a clone.

`attn_impl="pallas"` runs prefill attention through the flash-attention
wrapper (K4: the CUDA kernel on the card, its plain version for CPU
tensors); `"ref"` keeps the JAX package's plain path (`_full_attn`).
Decode attention over the ring is plain torch ops in both, as in the JAX
package.  MLA runs `_full_attn` whatever `attn_impl` says, as the JAX
package's `mla_forward` does (its q/k width 192 and v width 128 are not a
shape K4 takes); so do non-causal attention (`gqa_forward(causal=False)`,
the audio encoder) and `cross_attn`, through the plain `_sdpa` with no
mask, as in the JAX package, which never sends them to its flash kernel.

On a mesh (`sharding.ctx.ShardCtx`), K4 is never taken, as in the JAX
package.  Where the `model` axis has more than one rank (`tp`, a
`models.tensor_parallel.TP`), the projections are this rank's blocks:
wq / wk / wv (MLA's q_up / kv_up) column blocks, wo a row block.  Where
the kv heads divide `model` the blocks are whole heads and attention is
head-parallel: each rank attends with its heads, with no collective
inside (MLA: its heads always divide `model` at the rules' meshes; the
replicated latent's rotary key takes its gradient from every rank's
heads).  Where they do not, a column block splits a head: the projected
q, k and v are all-gathered over `model` (activations) and rotated after
the gather, attention runs on the whole heads (attn_shard="explicit":
`sharded_causal_attention`'s sequence-parallel case), and its output's
columns go through wo's row block.  A decode step gathers its one
token's q, k and v heads.  MLA's decode on such a mesh runs in latent
space whatever `mla_absorb` says: the naive form needs every head's
kv_up against every slot, which the head-sharded weights and the
length-sharded cache hold on different ranks.  On a `model` axis of one
rank, with attn_shard="explicit" full-sequence causal attention runs
through `sharded_causal_attention`, else the plain path.  A meshed decode
cache holds this rank's block of the cache length (the
layout of `sharding.partition.cache_shardings`: "k" / "v" / "c_kv" /
"k_pe" along C, "pos" and "idx" whole): the token's slot is written by the
rank that owns it (`_ring_write`, an owner mask, no host read), and each
rank's softmax over its slots is combined over `model` in flash-decoding
order (`_decode_softmax`: the max, then each rank's share of the mass,
then the weighted outputs, three all-reduces of a (B, H, 1) statistic or
the output).  A cache whose length `model` does not divide is held whole
and read as on one device.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..kernels.flash_attention.ops import flash_attention
from ..sharding import comm
from ..sharding.ctx import meshed
from . import tensor_parallel as TPM
from .layers import DTYPE, apply_mrope, apply_rope, dense, dense_init

__all__ = ["gqa_init", "gqa_forward", "gqa_decode", "init_kv_cache", "mla_init",
           "mla_forward", "mla_decode", "init_mla_cache", "cross_attn_init", "cross_attn",
           "sharded_causal_attention"]

NEG_INF = -1e30


# --------------------------------------------------------------------------
# Core softmax attention on grouped heads.
# --------------------------------------------------------------------------

def _sdpa(q, k, v, mask, scale):
    """q: (B,Sq,Hkv,G,Dh); k,v: (B,Sk,Hkv,Dh); mask: broadcastable to
    (B,Hkv,G,Sq,Sk) or None.  Probabilities are cast to v's dtype before
    P.V, as in the JAX package."""
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)


def _causal_mask(sq: int, sk: int, q_offset, window: int, device):
    """(1,1,1,Sq,Sk) boolean; window = 0 means full causal."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    kj = torch.arange(sk, device=device)[None, :]
    m = kj <= qi
    if window > 0:
        m &= kj > qi - window
    return m[None, None, None]


def _chunked_sdpa(q, k, v, scale, window: int, chunk: int, q_offset: int = 0,
                  remat: bool = False):
    """Flash-style: a loop over query chunks (the JAX package's lax.scan);
    peak memory per step is (B,Hkv,G,chunk,Sk) instead of (...,Sq,Sk).
    q_offset shifts the causal mask for a sequence-parallel query block.
    remat: keep only each chunk's inputs for the backward pass and
    recompute its scores there (torch.utils.checkpoint; the same bits),
    so a backward pass holds one chunk's scores, not every chunk's."""
    sq = q.shape[1]
    assert sq % chunk == 0, (sq, chunk)
    outs = []
    for i in range(sq // chunk):
        mask = _causal_mask(chunk, k.shape[1], i * chunk + q_offset, window, q.device)
        q_i = q[:, i * chunk:(i + 1) * chunk]
        outs.append(checkpoint(_sdpa, q_i, k, v, mask, scale, use_reentrant=False) if remat
                    else _sdpa(q_i, k, v, mask, scale))
    return torch.cat(outs, dim=1)


def _full_attn(qg, k, v, scale, window: int, chunk: int, q_offset: int = 0,
               remat: bool = False):
    """Dispatch: chunked loop for long sequences (its chunks rematerialised
    with `remat`), one-shot otherwise."""
    s = qg.shape[1]
    if chunk and s > 2 * chunk:
        return _chunked_sdpa(qg, k, v, scale, window, chunk, q_offset, remat)
    mask = _causal_mask(s, k.shape[1], q_offset, window, qg.device)
    return _sdpa(qg, k, v, mask, scale)


def _remat_chunks(ctx) -> bool:
    """Whether full-sequence attention rematerialises its query chunks: on
    a mesh under autograd, where attn_shard="auto" runs it whole on every
    model rank (one-device training keeps every chunk's scores, as the JAX
    package's scan does)."""
    return meshed(ctx) and torch.is_grad_enabled()


def sharded_causal_attention(qg, k, v, scale, window: int, chunk: int, ctx):
    """Full-sequence causal attention partitioned over the `model` axis
    (the JAX package's shard_map version), as per-rank code; qg (B, S, Hkv,
    G, Dh), k and v (B, S, Hkv, Dh*) enter whole on every model rank (the
    residual stream is replicated over `model`):

      * head-parallel when Hkv % model == 0: each rank attends with its
        Hkv / model kv-head groups over the whole sequence; no collective
        inside, one all-gather of the heads' outputs after;
      * sequence-parallel otherwise, when S % model == 0: each rank takes
        its S / model query rows at their offset against the whole K / V,
        which every rank already holds (their gradient is all-reduced),
        and the rows' outputs are all-gathered;
      * else the plain path, whole on every rank.

    The operators of `sharding.comm` give each rank the complete gradient
    of the replicated q, k and v."""
    group, mp = ctx.group("model"), ctx.size("model")
    s, hkv = qg.shape[1], qg.shape[2]
    if hkv % mp == 0:
        q_l, k_l, v_l = (comm.split_to(t, group, 2) for t in (qg, k, v))
        return comm.gather_from(_full_attn(q_l, k_l, v_l, scale, window, chunk), group, 2)
    if s % mp == 0:
        s_loc = s // mp
        q_l = comm.split_to(qg, group, 1)
        out = _full_attn(q_l, comm.copy_to(k, group), comm.copy_to(v, group), scale, window,
                         min(chunk, s_loc) if chunk else 0, ctx.rank("model") * s_loc)
        return comm.gather_from(out, group, 1)
    return _full_attn(qg, k, v, scale, window, chunk)



# --------------------------------------------------------------------------
# GQA
# --------------------------------------------------------------------------

def gqa_init(gen: torch.Generator, cfg: ArchConfig):
    dh = cfg.head_dim
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * dh, bias=cfg.qkv_bias),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * dh, bias=cfg.qkv_bias),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * dh, bias=cfg.qkv_bias),
        "wo": dense_init(gen, cfg.n_heads * dh, cfg.d_model),
    }


def _heads_mode(tp, p, cfg: ArchConfig):
    """How a meshed GQA (or cross-attention) layer's heads lie over
    `model`: None off a mesh or on one model rank, "heads" where the kv
    heads divide it (head-parallel), else "gather" (the column blocks split
    a head).  Refuses a leaf that is not its rules' block."""
    if tp is None:
        return None
    dh = cfg.head_dim
    for name, n in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads), ("wv", cfg.n_kv_heads)):
        TPM.block(tp, p[name]["w"], 1, n * dh, name)
    TPM.block(tp, p["wo"]["w"], 0, cfg.n_heads * dh, "wo")
    return "heads" if cfg.n_kv_heads % tp.size == 0 else "gather"


def _project_qkv(p, cfg: ArchConfig, x, positions, mrope_pos=None, tp=None, gather=False):
    """q, k rotated by M-RoPE at `mrope_pos` (B, S, 3) when cfg.use_mrope
    and it is given, else by RoPE at `positions`; v as projected.  On a
    mesh (`tp`) this rank's heads, or with `gather` every head (the
    projections gathered over `model` before the rotation, which pairs
    channels within a head)."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    q, k, v = TPM.cols(tp, [p["wq"], p["wk"], p["wv"]], x)
    if gather:
        q, k, v = (TPM.gather_cols(tp, t) for t in (q, k, v))
    q = q.reshape(b, s, q.shape[-1] // dh, dh)
    k = k.reshape(b, s, k.shape[-1] // dh, dh)
    v = v.reshape(b, s, v.shape[-1] // dh, dh)
    if cfg.use_mrope and mrope_pos is not None:
        sections = _mrope_sections(dh)
        return (apply_mrope(q, mrope_pos, cfg.rope_theta, sections),
                apply_mrope(k, mrope_pos, cfg.rope_theta, sections), v)
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def _mrope_sections(dh: int) -> tuple[int, int, int]:
    """Split Dh/2 frequency pairs into (t, h, w) ~ (1/4, 3/8, 3/8)."""
    half = dh // 2
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


def gqa_forward(p, cfg: ArchConfig, x, *, positions=None, mrope_pos=None, chunk: int = 0,
                causal: bool = True, return_kv: bool = False, ctx=None, tp=None):
    """Training / prefill self-attention: causal with an optional sliding
    window, or with causal=False unmasked (the audio encoder), through the
    plain `_sdpa` whatever `attn_impl` says.  q and k are rotated by M-RoPE
    at `mrope_pos` (B, S, 3) where cfg.use_mrope, else by RoPE at
    `positions` (default arange(S)).

    With return_kv=True also returns the rotated (k, v) so the serving path
    can seed a decode cache from prefill (every kv head).  `ctx`
    (`sharding.ctx.ShardCtx`): on a mesh K4 is not taken, and
    attn_shard="explicit" routes causal attention on whole heads through
    `sharded_causal_attention`; `tp` partitions the layer over `model`
    (module docstring)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    mode = _heads_mode(tp, p, cfg)
    q, k, v = _project_qkv(p, cfg, x, positions, mrope_pos, tp, gather=mode == "gather")
    hkv, dh = k.shape[2], cfg.head_dim
    qg = q.reshape(b, s, hkv, cfg.n_heads // cfg.n_kv_heads, dh)
    if not causal:
        out = _sdpa(qg, k, v, None, dh**-0.5)
    elif cfg.attn_impl == "pallas" and not meshed(ctx):
        out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    elif meshed(ctx) and ctx.attn_shard == "explicit" and mode != "heads":
        out = sharded_causal_attention(qg, k, v, dh**-0.5, cfg.sliding_window, chunk, ctx)
    else:
        out = _full_attn(qg, k, v, dh**-0.5, cfg.sliding_window, chunk,
                         remat=_remat_chunks(ctx))
    out = out.reshape(b, s, q.shape[2] * dh)
    y = TPM.row(tp, p["wo"], TPM.split_cols(tp, out) if mode == "gather" else out)
    if return_kv:
        if mode == "heads":
            k, v = (comm.gather_(t, tp.group, 2) for t in (k, v))
        return y, (k, v)
    return y


def init_kv_cache(cfg: ArchConfig, batch: int, cache_len: int, device):
    dh = cfg.head_dim
    return {
        "k": torch.zeros(batch, cache_len, cfg.n_kv_heads, dh, dtype=DTYPE, device=device),
        "v": torch.zeros(batch, cache_len, cfg.n_kv_heads, dh, dtype=DTYPE, device=device),
        "pos": torch.full((cache_len,), -1, dtype=torch.int32, device=device),
        "idx": torch.zeros((), dtype=torch.int32, device=device),
    }


def _length_block(cache, name: str, ctx):
    """(offset, length) of this rank's block of the ring's slots when the
    meshed cache holds its block of the cache length along axis 1 of
    `name` (it is 1 / model of "pos"), else None (one device, or a cache
    length `model` does not divide, held whole)."""
    if not meshed(ctx):
        return None
    c, c_loc, mp = cache["pos"].shape[0], cache[name].shape[1], ctx.size("model")
    if c_loc * mp != c:
        return None
    return ctx.rank("model") * c_loc, c_loc


def _ring_write(cache, entries: dict, cur_pos, window: int, block=None):
    """Write `entries` (name -> (B, 1, ...)) at slot idx % C of the ring (its
    sequence axis 1) and cur_pos at that slot of "pos", advance idx, all in
    place; returns the (C,) mask of the slots a query at cur_pos sees.
    With `block` = (offset, length) the entries hold this rank's slots
    only: the owner of the slot writes the token there, every other rank
    rewrites its own slot (clamped into its block) with what it holds."""
    c = cache["pos"].shape[0]
    slot = (cache["idx"] % c).reshape(1).long()
    if block is None:
        for name, value in entries.items():
            cache[name].index_copy_(1, slot, value)
    else:
        off, c_loc = block
        local = slot - off
        own = (local >= 0) & (local < c_loc)
        local = local.clamp(0, c_loc - 1)
        for name, value in entries.items():
            held = cache[name].index_select(1, local)
            cache[name].index_copy_(1, local, torch.where(own, value, held))
    cache["pos"].index_copy_(0, slot, cur_pos.reshape(1).to(torch.int32))
    cache["idx"].add_(1)
    pos = cache["pos"]
    valid = (pos >= 0) & (pos <= cur_pos)
    if window > 0:
        valid &= pos > cur_pos - window
    return valid


def _decode_softmax(logits, ctx):
    """Flash-decoding's combine of a length-sharded softmax: `logits` (...,
    C_local) f32 over this rank's slots (masked).  Returns (probs, share):
    the softmax over this rank's slots alone, and share (...,) its slots'
    part of the whole softmax mass, l_r exp(m_r - M) / sum_r' l_r'
    exp(m_r' - M) with m_r its max, l_r its sum of exp(logits - m_r) and M
    the max over `model`; the output is sum_r share_r (probs_r . V_r).  On
    one model rank share is l / l = 1 exactly, so the output is the plain
    softmax's bits."""
    group = ctx.group("model")
    probs = torch.softmax(logits, dim=-1)
    m = logits.amax(-1)
    m_all = comm.all_reduce_max_(m.clone(), group)
    mass = torch.exp(logits - m[..., None]).sum(-1) * torch.exp(m - m_all)
    return probs, mass / comm.all_reduce_(mass.clone(), group)


def _combine(out, share, ctx):
    """sum over `model` of share * out (f32), cast back to out's dtype."""
    return comm.all_reduce_(out.float() * share, ctx.group("model")).to(out.dtype)


def _sdpa_sharded(q, k, v, mask, scale, ctx):
    """`_sdpa` over this rank's block of the slots (k, v: (B, C_local,
    Hkv, Dh); mask over them), combined over `model` (`_decode_softmax`)."""
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    logits = torch.where(mask, logits, NEG_INF)
    probs, share = _decode_softmax(logits, ctx)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return _combine(out, share.permute(0, 3, 1, 2)[..., None], ctx)


def gqa_decode(p, cfg: ArchConfig, x, cache, cur_pos, *, mrope_pos=None, ctx=None, tp=None):
    """One-token decode: x (B, 1, d); cur_pos a () int32 tensor, the global
    position, on x's device (no host read); with cfg.use_mrope, mrope_pos
    (B, 1, 3) the token's M-RoPE position.  Writes slot idx % C of the
    cache in place, advances its idx, and returns (y, cache).  On a mesh
    whose cache holds this rank's block of the length, attention runs over
    the block and is combined over `model` (module docstring); with `tp`
    the token's q, k and v heads are gathered and wo is a row block."""
    b = x.shape[0]
    dh = cfg.head_dim
    hkv = cfg.n_kv_heads
    g = cfg.n_heads // hkv
    positions = cur_pos.reshape(1, 1).expand(b, 1)
    mode = _heads_mode(tp, p, cfg)
    q, k, v = _project_qkv(p, cfg, x, positions, mrope_pos, tp, gather=mode is not None)
    block = _length_block(cache, "k", ctx)
    valid = _ring_write(cache, {"k": k, "v": v}, cur_pos, cfg.sliding_window, block)

    qg = q.reshape(b, 1, hkv, g, dh)
    if block is None:
        out = _sdpa(qg, cache["k"], cache["v"], valid[None, None, None, None, :], dh**-0.5)
    else:
        valid = valid[block[0]:block[0] + block[1]]
        out = _sdpa_sharded(qg, cache["k"], cache["v"], valid[None, None, None, None, :],
                            dh**-0.5, ctx)
    y = TPM.row(tp, p["wo"], TPM.split_cols(tp, out.reshape(b, 1, cfg.n_heads * dh)))
    return y, cache


# --------------------------------------------------------------------------
# MLA (deepseek-v3): low-rank latent KV, decoupled RoPE key.
# --------------------------------------------------------------------------

def mla_init(gen: torch.Generator, cfg: ArchConfig):
    h = cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "q_down": dense_init(gen, cfg.d_model, cfg.q_lora_rank),
        "q_up": dense_init(gen, cfg.q_lora_rank, h * qk),
        "kv_down": dense_init(gen, cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_dim),
        "kv_up": dense_init(gen, cfg.kv_lora_rank, h * (cfg.qk_nope_dim + cfg.v_head_dim)),
        "wo": dense_init(gen, h * cfg.v_head_dim, cfg.d_model),
    }


def _mla_tp(tp, p, cfg: ArchConfig):
    """`tp` for an MLA layer, after checking its blocks: q_up and kv_up
    column blocks of whole heads, wo a row block.  Refuses heads that do
    not divide `model` (every mesh of the rules divides deepseek-v3's
    128)."""
    if tp is None:
        return None
    h = cfg.n_heads
    if h % tp.size:
        leaf = ".".join(str(k) for k in tp.where + ("q_up",))
        raise ValueError(f"{leaf}: MLA's {h} heads do not divide model={tp.size}; its "
                         "tensor-parallel form takes whole heads per rank")
    TPM.block(tp, p["q_up"]["w"], 1, h * (cfg.qk_nope_dim + cfg.qk_rope_dim), "q_up")
    TPM.block(tp, p["kv_up"]["w"], 1, h * (cfg.qk_nope_dim + cfg.v_head_dim), "kv_up")
    TPM.block(tp, p["wo"]["w"], 0, h * cfg.v_head_dim, "wo")
    return tp


def _mla_q(p, cfg: ArchConfig, xq, positions, tp=None):
    """Queries (B, Sq, H, dn + dr), the last dr columns rotated at
    `positions` (on a mesh this rank's H / model heads)."""
    b, sq, _ = xq.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = TPM.col(tp, p["q_up"], dense(p["q_down"], xq)).reshape(b, sq, -1, dn + dr)
    return torch.cat([q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)], -1)


def _mla_kv_from_latent(p, cfg: ArchConfig, c_kv, k_pe, tp=None):
    """Up-project the latent (key side): k (B, Sk, H, dn + dr) with the
    rotated k_pe broadcast over the heads, v (B, Sk, H, dv); on a mesh
    this rank's heads, k_pe's gradient summed over them all."""
    b, sk, _ = c_kv.shape
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kv = TPM.col(tp, p["kv_up"], c_kv).reshape(b, sk, -1, dn + dv)
    h = kv.shape[2]
    if tp is not None:
        k_pe = comm.copy_to_f32(k_pe, tp.group)
    k = torch.cat([kv[..., :dn], k_pe[:, :, None, :].expand(b, sk, h, dr)], -1)
    return k, kv[..., dn:]


def _mla_latent(p, cfg: ArchConfig, x, positions):
    """(c_kv (B, S, r), k_pe (B, S, dr) rotated at `positions`)."""
    down = dense(p["kv_down"], x)
    r = cfg.kv_lora_rank
    k_pe = apply_rope(down[..., None, r:], positions, cfg.rope_theta)[:, :, 0, :]
    return down[..., :r], k_pe


def mla_forward(p, cfg: ArchConfig, x, *, positions=None, chunk: int = 0,
                return_kv: bool = False, ctx=None, tp=None):
    """Training / prefill MLA (causal, optional sliding window), through
    `_full_attn` with one query head per key head (on a mesh with
    attn_shard="explicit" and one model rank, `sharded_causal_attention`;
    with `tp`, head-parallel on this rank's heads).  With return_kv=True
    also returns the latent (c_kv, k_pe) that seeds the decode cache."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    tp = _mla_tp(tp, p, cfg)
    c_kv, k_pe = _mla_latent(p, cfg, x, positions)
    k, v = _mla_kv_from_latent(p, cfg, c_kv, k_pe, tp)
    q = _mla_q(p, cfg, x, positions, tp)
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    if meshed(ctx) and ctx.attn_shard == "explicit" and tp is None:
        out = sharded_causal_attention(q[:, :, :, None, :], k, v, scale, cfg.sliding_window,
                                       chunk, ctx)[:, :, :, 0]
    else:
        out = _full_attn(q[:, :, :, None, :], k, v, scale, cfg.sliding_window,
                         chunk, remat=_remat_chunks(ctx))[:, :, :, 0]
    y = TPM.row(tp, p["wo"], out.reshape(b, s, q.shape[2] * cfg.v_head_dim))
    if return_kv:
        return y, (c_kv, k_pe)
    return y


def init_mla_cache(cfg: ArchConfig, batch: int, cache_len: int, device):
    """The latent (kv_lora + rope) per token, not per-head K/V."""
    return {
        "c_kv": torch.zeros(batch, cache_len, cfg.kv_lora_rank, dtype=DTYPE, device=device),
        "k_pe": torch.zeros(batch, cache_len, cfg.qk_rope_dim, dtype=DTYPE, device=device),
        "pos": torch.full((cache_len,), -1, dtype=torch.int32, device=device),
        "idx": torch.zeros((), dtype=torch.int32, device=device),
    }


def mla_decode(p, cfg: ArchConfig, x, cache, cur_pos, ctx=None, tp=None):
    """One-token MLA decode: x (B, 1, d), cur_pos a () int32 tensor on x's
    device.  Writes the token's latent at slot idx % C in place, advances
    idx, and returns (y, cache).  Two modes, as in the JAX package:

    * naive: up-project the whole latent cache to per-head K/V, then
      attention over the ring;
    * absorbed (cfg.mla_absorb): fold kv_up into the query and output
      projections (f32 einsums), so attention runs in the latent space and
      no per-head K/V exists.  The same math in another order.

    On a mesh whose cache holds this rank's block of the length, both run
    over the block's latents and are combined over `model`.  With `tp` the
    absorbed form runs (module docstring): this rank's heads' queries in
    latent space, gathered over `model` for the slots of the block, and
    each rank's heads of the combined latent output through its slice of
    kv_up and its row block of wo."""
    b = x.shape[0]
    dn, dr, h, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.n_heads, cfg.v_head_dim
    tp = _mla_tp(tp, p, cfg)
    positions = cur_pos.reshape(1, 1).expand(b, 1)
    c_new, k_pe_new = _mla_latent(p, cfg, x, positions)
    block = _length_block(cache, "c_kv", ctx)
    valid = _ring_write(cache, {"c_kv": c_new, "k_pe": k_pe_new}, cur_pos, cfg.sliding_window,
                        block)
    if block is not None:
        valid = valid[block[0]:block[0] + block[1]]
    c_kv, k_pe = cache["c_kv"], cache["k_pe"]
    q = _mla_q(p, cfg, x, positions, tp)
    scale = (dn + dr) ** -0.5
    if cfg.mla_absorb or tp is not None:
        w_up = p["kv_up"]["w"].reshape(cfg.kv_lora_rank, q.shape[2], dn + dv).float()
        w_k, w_v = w_up[..., :dn], w_up[..., dn:]
        q_abs = torch.einsum("bqhd,rhd->bqhr", q[..., :dn].float(), w_k)
        q_pe = q[..., dn:]
        if tp is not None:
            q_abs, q_pe = (TPM.gather_cols(tp, t, 2) for t in (q_abs, q_pe))
        logits = torch.einsum("bqhr,bcr->bhqc", q_abs, c_kv.float())
        logits = logits + torch.einsum("bqhd,bcd->bhqc", q_pe.float(), k_pe.float())
        logits = torch.where(valid, logits * scale, NEG_INF)
        if block is None:
            probs = torch.softmax(logits, dim=-1)
            o_lat = torch.einsum("bhqc,bcr->bqhr", probs, c_kv.float())
        else:
            probs, share = _decode_softmax(logits, ctx)
            o_lat = _combine(torch.einsum("bhqc,bcr->bqhr", probs, c_kv.float()),
                             share.permute(0, 2, 1)[..., None], ctx)
        out = torch.einsum("bqhr,rhd->bqhd", TPM.split_cols(tp, o_lat, 2), w_v).to(x.dtype)
    else:
        k, v = _mla_kv_from_latent(p, cfg, c_kv, k_pe)
        if block is None:
            out = _sdpa(q[:, :, :, None, :], k, v, valid, scale)[:, :, :, 0]
        else:
            out = _sdpa_sharded(q[:, :, :, None, :], k, v, valid, scale, ctx)[:, :, :, 0]
    return TPM.row(tp, p["wo"], out.reshape(b, 1, out.shape[2] * dv)), cache


# --------------------------------------------------------------------------
# Cross-attention (whisper decoder -> encoder output)
# --------------------------------------------------------------------------

def cross_attn_init(gen: torch.Generator, cfg: ArchConfig):
    dh = cfg.head_dim
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * dh, bias=cfg.qkv_bias),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * dh),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * dh),
        "wo": dense_init(gen, cfg.n_heads * dh, cfg.d_model),
    }


def cross_attn(p, cfg: ArchConfig, x, enc_out, tp=None):
    """x: (B, Sq, d) decoder stream; enc_out: (B, Se, d).  No mask, no RoPE
    (whisper uses absolute positions on the encoder); K and V are projected
    from enc_out at every call, decode steps included, as in the JAX
    package.  With `tp`, partitioned over `model` as `gqa_forward`: this
    rank's heads, or every head gathered where the kv heads do not divide
    `model`."""
    b, sq, _ = x.shape
    se = enc_out.shape[1]
    dh = cfg.head_dim
    mode = _heads_mode(tp, p, cfg)
    q = TPM.col(tp, p["wq"], x)
    k, v = TPM.cols(tp, [p["wk"], p["wv"]], enc_out)
    if mode == "gather":
        q, k, v = (TPM.gather_cols(tp, t) for t in (q, k, v))
    hkv = k.shape[-1] // dh
    q = q.reshape(b, sq, hkv, cfg.n_heads // cfg.n_kv_heads, dh)
    k = k.reshape(b, se, hkv, dh)
    v = v.reshape(b, se, hkv, dh)
    out = _sdpa(q, k, v, None, dh**-0.5).reshape(b, sq, q.shape[2] * q.shape[3] * dh)
    return TPM.row(tp, p["wo"], TPM.split_cols(tp, out) if mode == "gather" else out)
