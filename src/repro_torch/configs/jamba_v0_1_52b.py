"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887]

Assigned spec: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
MoE 16e top-2.  Period-8 blocks: attention at in-block index 4 (1 attn : 7
mamba), MoE FFN on odd layers (every other), dense SwiGLU on even.
long_500k is natively servable: mamba state is O(1), the 4 attention layers
use the GQA KV cache (full 32k cache for decode_32k; the hybrid's attention
memory is 8x smaller than a pure transformer already).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    moe_d_ff=14336,
    vocab=65536,
    rope_theta=1e4,
    n_experts=16,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=4,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    long_context="native (mamba state + 4 full-attn layers, B=1 cache)",
    optimizer="adafactor",
)
