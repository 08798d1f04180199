"""stablelm-3b [dense] — MHA (kv = heads). [hf:stabilityai/stablelm family]

Assigned spec: 32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50304,
    rope_theta=1e4,
    long_context="long_500k via SWA variant (long_window=8192)",
    optimizer="adamw",
)
