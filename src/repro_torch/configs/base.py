"""Architecture configuration schema of the model zoo (copy of the JAX
package's `configs/base.py`).

Every architecture is a frozen `ArchConfig`; reduced smoke variants
(2 layers, d_model <= 512, <= 4 experts) are derived via `reduced()` so smoke
tests exercise the *same* code paths as the full configs.  The port keeps
every field, so a config maps 1:1 onto the JAX package's.  In the port,
`attn_impl="pallas"` and `rwkv_wkv_impl="pallas"` select the hand-written
CUDA kernels (their plain versions for CPU tensors), `"ref"` the plain
torch path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                    # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                 # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attn_impl: str = "ref"          # "ref" (plain sdpa) | "pallas" (flash kernel K4)

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0               # per-expert hidden (0 -> d_ff)
    n_shared_experts: int = 0
    moe_every: int = 1              # MoE FFN on layers where i % moe_every == moe_offset
    moe_offset: int = 0
    n_dense_layers: int = 0         # leading dense layers (deepseek-v3: 3)
    dense_d_ff: int = 0             # FFN width of the dense layers (0 -> d_ff)
    router_aux_coef: float = 0.001

    # --- MLA (deepseek) ------------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mla_absorb: bool = False        # decode in latent space (§Perf optimization)

    # --- SSM / hybrid --------------------------------------------------------
    ssm_type: str = ""              # "rwkv6" | "mamba"
    rwkv_wkv_impl: str = "ref"      # "ref" (plain loop) | "pallas" (WKV kernel K5)
    rwkv_head_size: int = 64
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    attn_every: int = 0             # jamba: 1 attention layer per this many (period)
    attn_offset: int = 0            # index of the attn layer within the period

    # --- encoder-decoder (whisper) -------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500         # stubbed conv/mel frontend output length

    # --- VLM (qwen2-vl) -------------------------------------------------------
    use_mrope: bool = False
    n_patches: int = 256            # stubbed ViT frontend output length

    # --- long-context / serving ----------------------------------------------
    sliding_window: int = 0         # 0 -> full attention; >0 -> SWA window
    long_window: int = 8192         # SWA window applied ONLY for long_500k
    long_context: str = ""          # note for DESIGN: how long_500k is served

    def for_shape(self, shape: "InputShape") -> "ArchConfig":
        """Shape-specific variant: long-context decode on attention archs
        switches to the sliding-window variant (long_window); SSM/hybrid are
        natively sub-quadratic and unchanged."""
        if (shape.kind == "decode" and shape.seq_len > 65536
                and self.n_heads > 0 and self.family not in ("ssm", "hybrid")
                and self.sliding_window == 0):
            return dataclasses.replace(self, sliding_window=self.long_window)
        return self

    # --- extras ----------------------------------------------------------------
    mtp: bool = False               # deepseek multi-token prediction head
    mtp_weight: float = 0.3

    # --- training -----------------------------------------------------------
    optimizer: str = "adamw"        # dry-run optimizer (adafactor for >=100B)

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def ffn_dense(self) -> int:
        return self.dense_d_ff or self.d_ff

    @property
    def ffn_expert(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0 or i < self.n_dense_layers:
            return False
        return (i - self.n_dense_layers) % self.moe_every == self.moe_offset

    def is_attn_layer(self, i: int) -> bool:
        """hybrid: which layers are attention (the rest are SSM)."""
        if self.family != "hybrid":
            return self.n_heads > 0
        return i % self.attn_every == self.attn_offset

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/code path, toy dimensions."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = min(self.n_kv_heads, max(1, n_heads // 2)) if n_heads else 0
        n_layers = max(2, self.attn_every or 2) if self.family == "hybrid" else 2
        kw = dict(
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_head=(d_model // n_heads if n_heads else 0),
            d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 1024),
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            moe_d_ff=min(self.ffn_expert, 128) if self.n_experts else 0,
            dense_d_ff=min(self.ffn_dense, 512),
            n_dense_layers=min(self.n_dense_layers, 1),
            q_lora_rank=min(self.q_lora_rank, 64),
            kv_lora_rank=min(self.kv_lora_rank, 32),
            qk_nope_dim=min(self.qk_nope_dim, 32),
            qk_rope_dim=min(self.qk_rope_dim, 16),
            v_head_dim=min(self.v_head_dim, 32),
            rwkv_head_size=min(self.rwkv_head_size, 32),
            n_encoder_layers=min(self.n_encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 64),
            n_patches=min(self.n_patches, 16),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
        )
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
