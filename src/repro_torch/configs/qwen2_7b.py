"""qwen2-7b [dense] — GQA kv=4, QKV bias. [arXiv:2407.10671]

Assigned spec: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    long_context="long_500k via SWA variant (long_window=8192)",
    optimizer="adamw",
)
