"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.
[arXiv:2412.19437]

Assigned spec: 61L d_model=7168 128H (kv=128 -> MLA latent) d_ff=2048
vocab=129280, MoE 256e top-8.  d_ff=2048 is the routed-expert hidden; the
3 leading dense layers use 18432 (= 9 x 2048, the DS-V3 paper value).
MLA makes the effective kv "heads" a 512-dim latent + 64-dim rope key.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_head=128,
    d_ff=2048,
    dense_d_ff=18432,
    moe_d_ff=2048,
    vocab=129280,
    rope_theta=1e4,
    # MoE
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    moe_every=1,
    n_dense_layers=3,
    # MLA
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    # long_500k served via MLA latent cache + sliding window
    long_context="long_500k via SWA variant (long_window=8192)",
    mtp=True,
    optimizer="adafactor",  # Adam states (~14 B/param) exceed one accelerator at 671B
)
