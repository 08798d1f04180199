"""qwen1.5-110b [dense] — GQA kv=8, QKV bias. [hf:Qwen/Qwen1.5 family]

Assigned spec: 80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,

    long_context="long_500k via SWA variant (long_window=8192)",
    optimizer="adafactor",         # 110B; train_loop maps it to adamw, as the JAX package does
)
