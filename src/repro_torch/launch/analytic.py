"""Analytic FLOP / byte model for the roofline (PyTorch port's copy of the
JAX package's `launch/analytic.py`, with the formulas, their order of
operations and the control-plane op model unchanged, and the hardware an
NVIDIA H100).

The roofline's compute and memory terms are derived analytically from the
architecture config and input shape; `launch/dryrun.py` reports the FLOPs
counted on a meta-device run of the step (`launch/step_analysis.py`)
alongside as a cross-check.

Conventions:
  * 1 matmul MAC = 2 FLOPs; backward pass = 2x forward (dgrad + wgrad);
  * attention scores/AV: causal halves the window on train/prefill;
  * MoE: routed tokens = T x top_k x capacity_factor (+ shared experts);
  * memory term counts per-step HBM traffic: params (+opt state for train,
    x3 params for grads/updates), decode KV/state cache read+write, and
    activation traffic approximated as ACT_IO x T x d x n_layers x 2 bytes
    (remat-adjusted).

Hardware: the default `HW()` (exported as `H100`) is one H100 SXM 80GB
HBM3 at 700 W (NVIDIA data sheet, dense): bf16 989 TFLOP/s on the tensor
cores, HBM3 3.35 TB/s, NVLink 450 GB/s a direction, one card.  The
control plane's elementwise float64 / float32 math runs outside the tensor
cores: `GpuHW` (`GPU_HW`) prices it at 34 / 67 TFLOP/s beside `CpuHW`.
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ArchConfig, InputShape
from ..models.moe import CAPACITY_FACTOR

__all__ = ["HW", "H100", "analytic_cost", "model_flops", "param_counts",
           "OpCount", "OP_WEIGHTS", "CpuHW", "CPU_HW", "GpuHW", "GPU_HW", "g_eval_ops",
           "bisect_step_ops", "select_fixed_ops", "projection_ops",
           "polyblock_solve_cost", "roofline_pct"]

PEAK_FLOPS = 989e12  # bf16, dense, on the tensor cores
HBM_BW = 3.35e12
LINK_BW = 450e9      # NVLink 4, one direction
ACT_IO = 20          # activation tensors touched per token per layer (approx)


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW
    chips: int = 1


H100 = HW()


# --------------------------------------------------------------------------
# Parameter counts per sublayer kind (matmul weights only, analytic).
# --------------------------------------------------------------------------

def _attn_params(cfg: ArchConfig) -> int:
    dh = cfg.head_dim
    return cfg.d_model * (cfg.n_heads * dh + 2 * cfg.n_kv_heads * dh) + cfg.n_heads * dh * cfg.d_model


def _mla_params(cfg: ArchConfig) -> int:
    h = cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return (
        cfg.d_model * cfg.q_lora_rank
        + cfg.q_lora_rank * h * qk
        + cfg.d_model * (cfg.kv_lora_rank + cfg.qk_rope_dim)
        + cfg.kv_lora_rank * h * (cfg.qk_nope_dim + cfg.v_head_dim)
        + h * cfg.v_head_dim * cfg.d_model
    )


def _dense_ffn_params(cfg: ArchConfig) -> int:
    return 3 * cfg.d_model * cfg.ffn_dense


def _moe_params(cfg: ArchConfig) -> tuple[int, int]:
    """(total expert bank, active per token incl. shared + router)."""
    per_expert = 3 * cfg.d_model * cfg.ffn_expert
    total = cfg.n_experts * per_expert + cfg.n_shared_experts * per_expert
    active = (
        cfg.top_k * CAPACITY_FACTOR * per_expert
        + cfg.n_shared_experts * per_expert
        + cfg.d_model * cfg.n_experts  # router
    )
    return total, int(active)


def _rwkv_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    return 5 * d * d + d * 64 + 64 * d + d * cfg.d_ff + cfg.d_ff * d + d * d


def _mamba_params(cfg: ArchConfig) -> int:
    d, di, n = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state
    dtr = max(d // 16, 1)
    return d * 2 * di + cfg.mamba_d_conv * di + di * (dtr + 2 * n) + dtr * di + di * d


def param_counts(cfg: ArchConfig) -> dict:
    """Analytic totals: {'total': N, 'active': N_active} (matmul weights +
    embeddings)."""
    from ..models.transformer import stage_plan

    total = active = 0
    for st in stage_plan(cfg):
        for kind in st.pattern:
            if kind.mixer == "attn":
                t = a = _attn_params(cfg)
            elif kind.mixer == "mla":
                t = a = _mla_params(cfg)
            elif kind.mixer == "rwkv":
                t = a = _rwkv_params(cfg)
            else:
                t = a = _mamba_params(cfg)
            if kind.cross:
                t += _attn_params(cfg); a += _attn_params(cfg)
            if kind.ffn == "dense":
                t += _dense_ffn_params(cfg); a += _dense_ffn_params(cfg)
            elif kind.ffn == "moe":
                mt, ma = _moe_params(cfg)
                t += mt; a += ma
            total += t * st.repeats
            active += a * st.repeats
    if cfg.is_encoder_decoder:
        enc = (_attn_params(cfg) + _dense_ffn_params(cfg)) * cfg.n_encoder_layers
        total += enc; active += enc
    emb = 2 * cfg.vocab * cfg.d_model  # embed + lm_head
    total += emb; active += emb
    return {"total": total, "active": active}


# --------------------------------------------------------------------------
# FLOPs
# --------------------------------------------------------------------------

def _attn_score_flops(cfg: ArchConfig, b: int, sq: int, skv: float,
                      *, decode: bool = False) -> float:
    if cfg.use_mla:
        if decode and not cfg.mla_absorb:
            # Naive MLA decode re-up-projects the ENTIRE latent cache to
            # per-head K/V every step — the dominant decode cost the
            # mla_absorb variant removes (§Perf pair 3).
            up = 2.0 * b * skv * cfg.kv_lora_rank * cfg.n_heads * (
                cfg.qk_nope_dim + cfg.v_head_dim)
            sc = 2.0 * b * cfg.n_heads * sq * skv * (
                cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim)
            return up + sc
        if decode and cfg.mla_absorb:
            # Scores + AV run in the latent space (kv_r + rope dims).
            return 2.0 * b * cfg.n_heads * sq * skv * 2 * (
                cfg.kv_lora_rank + cfg.qk_rope_dim)
        dh = cfg.qk_nope_dim + cfg.qk_rope_dim
        dv = cfg.v_head_dim
        return 2.0 * b * cfg.n_heads * sq * skv * (dh + dv)
    dh = cfg.head_dim
    return 2.0 * b * cfg.n_heads * sq * skv * (dh + dh)


def _seq_mixer_state_flops(cfg: ArchConfig, b: int, s: int) -> float:
    if cfg.family == "ssm":  # rwkv: per token per head ~4*hs^2 ops
        return 4.0 * b * s * cfg.d_model * cfg.rwkv_head_size
    return 0.0


def _mamba_state_flops(cfg: ArchConfig, b: int, s: int) -> float:
    return 6.0 * b * s * cfg.mamba_d_inner * cfg.mamba_d_state


def model_flops(cfg: ArchConfig, shape: InputShape) -> dict:
    """Forward FLOPs (global); 'train_total' = 3x forward. Also the 6ND
    reference (N = active params)."""
    from ..models.transformer import stage_plan

    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        sq, tokens = 1, b
        skv_full = float(min(s, cfg.sliding_window or s))
    else:
        sq, tokens = s, b * s
        w = cfg.sliding_window or s
        # causal average kv length
        skv_full = (s / 2.0) if w >= s else (w - (w * w) / (2.0 * s))

    flops = 0.0
    for st in stage_plan(cfg):
        for kind in st.pattern:
            if kind.mixer == "attn":
                flops += st.repeats * (2.0 * tokens * _attn_params(cfg)
                                       + _attn_score_flops(cfg, b, sq, skv_full,
                                                           decode=shape.kind == "decode"))
            elif kind.mixer == "mla":
                flops += st.repeats * (2.0 * tokens * _mla_params(cfg)
                                       + _attn_score_flops(cfg, b, sq, skv_full,
                                                           decode=shape.kind == "decode"))
            elif kind.mixer == "rwkv":
                flops += st.repeats * (2.0 * tokens * _rwkv_params(cfg)
                                       + _seq_mixer_state_flops(cfg, b, sq))
            else:
                flops += st.repeats * (2.0 * tokens * _mamba_params(cfg)
                                       + _mamba_state_flops(cfg, b, sq))
            if kind.cross:
                flops += st.repeats * (2.0 * tokens * _attn_params(cfg)
                                       + 2.0 * b * cfg.n_heads * sq * cfg.encoder_seq
                                       * 2 * cfg.head_dim)
            if kind.ffn == "dense":
                flops += st.repeats * 2.0 * tokens * _dense_ffn_params(cfg)
            elif kind.ffn == "moe":
                _, active = _moe_params(cfg)
                flops += st.repeats * 2.0 * tokens * active
    if cfg.is_encoder_decoder and shape.kind != "decode":
        se = cfg.encoder_seq
        enc_tok = b * se
        per = 2.0 * enc_tok * (_attn_params(cfg) + _dense_ffn_params(cfg)) \
            + 2.0 * b * cfg.n_heads * se * se * 2 * cfg.head_dim
        flops += cfg.n_encoder_layers * per
    flops += 2.0 * tokens * cfg.vocab * cfg.d_model  # lm head
    if cfg.mtp and shape.kind == "train":
        flops += 2.0 * tokens * cfg.vocab * cfg.d_model

    pc = param_counts(cfg)
    return {
        "forward": flops,
        "train_total": 3.0 * flops,
        "six_nd_active": 6.0 * pc["active"] * tokens,
        "six_nd_total": 6.0 * pc["total"] * tokens,
        "tokens": tokens,
    }


# --------------------------------------------------------------------------
# Bytes + roofline terms
# --------------------------------------------------------------------------

def _param_bytes(cfg: ArchConfig) -> float:
    return 2.0 * param_counts(cfg)["total"]  # bf16


def _opt_bytes(cfg: ArchConfig) -> float:
    n = param_counts(cfg)["total"]
    if cfg.optimizer in ("adam", "adamw"):
        return 8.0 * n  # two f32 moments
    if cfg.optimizer == "adafactor":
        return 0.1 * n  # factored (rows+cols) -- small
    return 4.0 * n


def _cache_bytes(cfg: ArchConfig, shape: InputShape) -> float:
    from ..models.transformer import cache_len_for, stage_plan

    b = shape.global_batch
    clen = cache_len_for(cfg, shape.seq_len)
    total = 0.0
    for st in stage_plan(cfg):
        for kind in st.pattern:
            if kind.mixer == "attn":
                per = 2 * clen * cfg.n_kv_heads * cfg.head_dim * 2
            elif kind.mixer == "mla":
                per = clen * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
            elif kind.mixer == "rwkv":
                per = cfg.n_rwkv_heads * cfg.rwkv_head_size**2 * 4 + 2 * cfg.d_model * 2
            else:
                per = cfg.mamba_d_inner * (cfg.mamba_d_state * 4 + (cfg.mamba_d_conv - 1) * 2)
            total += st.repeats * per * b
    return total


def analytic_cost(cfg: ArchConfig, shape: InputShape, hw: HW = HW(),
                  collective_bytes_per_dev: float = 0.0) -> dict:
    """The three roofline terms (seconds) + supporting numbers."""
    mf = model_flops(cfg, shape)
    flops = mf["train_total"] if shape.kind == "train" else mf["forward"]

    b, s = shape.global_batch, shape.seq_len
    tokens = mf["tokens"]
    pbytes = _param_bytes(cfg)
    act = ACT_IO * tokens * cfg.d_model * cfg.n_layers * 2.0
    if shape.kind == "train":
        hbm = 3.0 * pbytes + 2.0 * _opt_bytes(cfg) + act * 2.0  # fwd+bwd traffic
    elif shape.kind == "prefill":
        hbm = pbytes + act
    else:
        hbm = pbytes + 2.0 * _cache_bytes(cfg, shape) + act

    compute_s = flops / (hw.chips * hw.peak_flops)
    memory_s = hbm / (hw.chips * hw.hbm_bw)
    collective_s = collective_bytes_per_dev / hw.link_bw

    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    return {
        **terms,
        "dominant": dominant,
        "flops_global": flops,
        "hbm_bytes_global": hbm,
        # 6ND counts fwd+bwd (train); inference forward is 2ND = 6ND / 3.
        "model_flops_6nd": mf["six_nd_active"] * (1.0 if shape.kind == "train" else 1 / 3),
        "useful_ratio": (mf["six_nd_active"] * (1.0 if shape.kind == "train" else 1 / 3))
        / max(flops, 1.0),
        "params_total": param_counts(cfg)["total"],
        "params_active": param_counts(cfg)["active"],
    }


# --------------------------------------------------------------------------
# Control plane: analytic op/byte model of the Algorithm-1 solvers.
#
# The learning-plane model above prices matmuls against the tensor cores;
# the control plane is branchy elementwise math, so its roofline needs a
# different op taxonomy (transcendentals and divides dominate, not MACs)
# and the rates outside the tensor cores: `CpuHW` for the host, `GpuHW`
# for the card, where K1 and K2 (`polyblock_fused`, `polyblock_project`)
# run it.  A percentage against a fixed analytic bound is an *absolute*
# regression tripwire, where a wall-clock ratio of two measured runs moves
# with every scheduling hiccup.
#
# Conventions (documented, deliberately round):
#   * costs are in ADD-EQUIVALENTS per element at full SIMD width — weights
#     are x86 AVX2 reciprocal throughputs relative to a vector add:
#     add/mul/fma-half/select/compare/min/max = 1, divide/sqrt = 4,
#     vectorized log1p = 12, vectorized exp = 10 (SVML/sleef-class);
#   * f32 runs at twice the f64 SIMD width, priced via `CpuHW.flops_f32`;
#   * memory traffic counts the state actually streamed per polyblock
#     iteration (the five vertex-store leaves, read + write, plus the
#     wireless operands), not allocator churn.
# --------------------------------------------------------------------------

OP_WEIGHTS = {"adds": 1.0, "muls": 1.0, "cmps": 1.0, "selects": 1.0,
              "minmax": 1.0, "divs": 4.0, "sqrts": 4.0,
              "log1ps": 12.0, "exps": 10.0}


@dataclasses.dataclass(frozen=True)
class OpCount:
    """Typed op tally for one element (one (pair, vertex) lane)."""

    adds: float = 0.0
    muls: float = 0.0
    divs: float = 0.0
    sqrts: float = 0.0
    minmax: float = 0.0
    cmps: float = 0.0
    selects: float = 0.0
    log1ps: float = 0.0
    exps: float = 0.0

    def __add__(self, o: "OpCount") -> "OpCount":
        return OpCount(**{f.name: getattr(self, f.name) + getattr(o, f.name)
                          for f in dataclasses.fields(self)})

    def __mul__(self, k: float) -> "OpCount":
        return OpCount(**{f.name: getattr(self, f.name) * k
                          for f in dataclasses.fields(self)})

    __rmul__ = __mul__

    def weighted(self) -> float:
        """Total cost in add-equivalents (see OP_WEIGHTS)."""
        return sum(OP_WEIGHTS[f.name] * getattr(self, f.name)
                   for f in dataclasses.fields(self))

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


@dataclasses.dataclass(frozen=True)
class CpuHW:
    """The benchmark container: 2 cores of an AVX2-class x86 server part.

    peak = cores x (256-bit lanes) x 2 (FMA) x ports x clock; the control
    plane's op mix has few fuseable MACs, so `flops_*` deliberately prices
    ONE port (the second FMA port is idle on select/compare chains).  The
    constants are round numbers, not a measured machine: the roofline gate
    compares runs of the SAME model over time, so only consistency matters.
    """

    cores: int = 2
    ghz: float = 3.0
    simd_f64: int = 4          # AVX2 256-bit lanes
    mem_gbps: float = 16.0     # container-visible stream bandwidth

    @property
    def flops_f64(self) -> float:
        return self.cores * self.simd_f64 * self.ghz * 1e9

    @property
    def flops_f32(self) -> float:
        return 2.0 * self.flops_f64


CPU_HW = CpuHW()


@dataclasses.dataclass(frozen=True)
class GpuHW:
    """`CpuHW`'s fields for one H100 SXM at 700 W (NVIDIA data sheet):
    float64 34 TFLOP/s and float32 67 TFLOP/s on the CUDA cores, outside
    the tensor cores, and HBM3 3 350 GB/s.  Like `CpuHW` it prices one
    add-equivalent per FLOP."""

    flops_f64: float = 34e12
    flops_f32: float = 67e12
    mem_gbps: float = 3350.0


GPU_HW = GpuHW()


def g_eval_ops() -> OpCount:
    """One evaluation of the energy constraint g of eq. (22), as spelled in
    `wireless.total_energy` / the kernels: u = p|h|^2 (1 mul), log1p, rate
    (2 muls), floor max, D/rate (1 div), E^cp (4 muls), E^cm (2 muls), the
    final adds."""
    return OpCount(adds=2, muls=9, divs=1, minmax=1, log1ps=1)


def _f_eval_ops() -> OpCount:
    """One evaluation of f = -T of eq. (8) (`wireless.total_time`)."""
    return OpCount(adds=2, muls=4, divs=2, minmax=2, log1ps=1)


def bisect_step_ops() -> OpCount:
    """One halving of the reference bisection: the midpoint, the scaled
    vertex, g at it, and the bracket update (a compare, two selects)."""
    return OpCount(adds=1, muls=3) + g_eval_ops() + OpCount(cmps=1, selects=2)


def select_fixed_ops() -> OpCount:
    """One selection's incumbent / retirement bookkeeping, beside the
    per-slot masked argmax over the store."""
    return OpCount(adds=2, cmps=3, selects=6, minmax=1)


def projection_ops(kind: str = "bisect", *, n_bisect: int = 60,
                   n_f32: int = 2, n_f64: int = 1) -> OpCount:
    """Ops for ONE projection (eqs. 27-29) of one vertex.

    kind: "bisect" (the reference 60-step halving), "newton" (the 14-step
    safeguarded log-space Newton of `project_newton`), or "mixed" (the
    fp32-bulk/fp64-polish Halley of `project_newton_mixed`; pass the
    driver's n_f32/n_f64 — f32 steps are priced at half cost via the
    doubled SIMD width, folded in here as x0.5).
    """
    need_root = g_eval_ops() + OpCount(cmps=1)
    step_bk = OpCount(cmps=1, selects=2)                 # bracket update
    if kind == "bisect":
        return need_root + n_bisect * bisect_step_ops() + OpCount(selects=1, muls=2)
    gp_extra = OpCount(adds=3, muls=5, divs=2)           # g' sharing the log1p
    if kind == "newton":
        step = (g_eval_ops() + gp_extra + step_bk
                + OpCount(muls=2, divs=1, exps=1, selects=1))
        warm = OpCount(adds=1, muls=2, divs=2, sqrts=1, minmax=3)
        return need_root + warm + 14 * step + OpCount(selects=1, muls=2, minmax=2)
    if kind == "mixed":
        g2_extra = OpCount(adds=4, muls=8, divs=2)       # Halley's g''
        f32_step = (g_eval_ops() + gp_extra + step_bk
                    + OpCount(muls=2, divs=1, exps=1, selects=1))
        f64_step = (g_eval_ops() + gp_extra + g2_extra + step_bk
                    + OpCount(adds=2, muls=4, divs=1, selects=1))
        warm = OpCount(adds=2, muls=6, divs=2, sqrts=2, minmax=5, cmps=1,
                       selects=2)
        return (need_root + 0.5 * (warm + n_f32 * f32_step)
                + n_f64 * f64_step + OpCount(selects=1, muls=2, minmax=2))
    raise ValueError(f"unknown projection kind: {kind}")


def polyblock_solve_cost(n_pairs: int, *, solver: str = "fused",
                         feasible_frac: float = 0.45,
                         mean_iters: float = 2.9, store_slots: float = 6.0,
                         pad_slack: float = 1.6, itemsize: int = 8,
                         hw: CpuHW | GpuHW = CPU_HW) -> dict:
    """Analytic compute/memory bound for one whole-horizon Γ solve.

    Stage model of the drivers in `core.monotonic_torch` (and the fused
    kernel, which runs the same trajectory):

      init      — Prop-1 filter + one cold projection of (1, 1) per
                  feasible pair;
      select    — per iteration: masked argmax over the `store_slots`-wide
                  store + incumbent/retirement bookkeeping;
      children  — per iteration: two child projections + f at both + the
                  masked one-hot store write (the store is re-streamed, so
                  this is also where the memory term lives).

    mean_iters is the empirical mean polyblock iteration count per feasible
    pair at Table-I physics (retirement histogram: p50 = 2, mean ~2.9,
    max ~16-24); pad_slack covers bucket padding plus the not-yet-compacted
    retired rows that the wide stages still carry (the {1,1.25,1.5,1.75}
    x 2^k ladder bounds pure padding at 25%, compaction lag adds the rest).

    solver: "step" (the step driver, newton projections), "fused" (the
    staged fused driver, mixed projections), or "pallas" (the single
    fused kernel, K1 `polyblock_fused`: bisection projections, but the
    store never round-trips through HBM — only the operands and results
    do).  The names are the JAX package's, so the two models compare.

    Returns compute_s / memory_s / bound_s (their max), the raw op and
    byte tallies, and the per-stage compute split.
    """
    if solver == "step":
        proj = projection_ops("newton")
        flops_rate = hw.flops_f64
    elif solver == "fused":
        proj = projection_ops("mixed")
        flops_rate = hw.flops_f64
    elif solver == "pallas":
        proj = projection_ops("bisect")
        flops_rate = hw.flops_f64 if itemsize == 8 else hw.flops_f32
    else:
        raise ValueError(f"unknown solver: {solver}")

    rows = n_pairs * feasible_frac * pad_slack
    iters = rows * mean_iters

    select = store_slots * OpCount(cmps=2, selects=2) + select_fixed_ops()
    write = store_slots * OpCount(cmps=2, selects=5) * 2.0
    init_ops = rows * (proj + _f_eval_ops()).weighted() \
        + n_pairs * g_eval_ops().weighted()              # Prop-1 filter
    select_ops = iters * select.weighted()
    children_ops = iters * (2.0 * (proj + _f_eval_ops()).weighted()
                            + write.weighted())
    flops = init_ops + select_ops + children_ops

    # Memory: the five store leaves (verts 2 + vproj 2 + vfval 1, plus the
    # valid bitmask) stream read+write each iteration in the array drivers;
    # the fused kernel keeps the store on chip (registers / shared memory)
    # and streams only operands in and results out.
    leaf_floats = 5.125
    if solver == "pallas":
        bytes_ = n_pairs * (3 + 4) * itemsize
    else:
        bytes_ = (iters * store_slots * leaf_floats * itemsize * 2.0
                  + iters * 3 * itemsize + n_pairs * 7 * itemsize)

    compute_s = flops / flops_rate
    memory_s = bytes_ / (hw.mem_gbps * 1e9)
    return {
        "solver": solver,
        "n_pairs": n_pairs,
        "flops_add_equiv": flops,
        "bytes": bytes_,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "bound_s": max(compute_s, memory_s),
        "dominant": "compute_s" if compute_s >= memory_s else "memory_s",
        "stage_compute": {
            "init": init_ops / flops_rate,
            "select": select_ops / flops_rate,
            "children": children_ops / flops_rate,
        },
    }


def roofline_pct(measured_s: float, cost: dict) -> float:
    """Percent of the analytic roofline achieved by a measured solve."""
    return 100.0 * cost["bound_s"] / max(measured_s, 1e-12)
