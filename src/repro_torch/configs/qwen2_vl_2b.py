"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution; ViT frontend STUBBED.
[arXiv:2409.12191]

Assigned spec: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
input_specs() provides precomputed patch embeddings (B, 256, 1536) spliced
over the first 256 token positions, plus (B, S, 3) M-RoPE position ids
(temporal / height / width streams).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1e6,
    use_mrope=True,
    n_patches=256,
    long_context="long_500k via SWA variant (long_window=8192)",
    optimizer="adamw",
)
