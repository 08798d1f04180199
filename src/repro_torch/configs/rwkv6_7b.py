"""rwkv6-7b [ssm] — "Finch", attention-free, data-dependent decay.
[arXiv:2404.05892]

Assigned spec: 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536.
head_size 64 -> 64 WKV heads; per-layer state is (B, 64, 64, 64) fp32.
long_500k is natively servable: the recurrent state is O(1) in sequence
length — this arch is the paper's best case for the long-context shape.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=14336,
    vocab=65536,
    ssm_type="rwkv6",
    rwkv_head_size=64,
    long_context="native (constant-size WKV state)",
    optimizer="adamw",
)
