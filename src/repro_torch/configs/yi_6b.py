"""yi-6b [dense] — llama-arch GQA kv=4. [arXiv:2403.04652]

Assigned spec: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    rope_theta=5e6,
    long_context="long_500k via SWA variant (long_window=8192)",
    optimizer="adamw",
)
