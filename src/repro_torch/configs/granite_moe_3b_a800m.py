"""granite-moe-3b-a800m [moe] — 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base family]

Assigned spec: 32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155,
MoE 40e top-8.  40 experts are zero-padded to 48 on a 16-way
expert-parallel axis (models.moe.pad_experts; `init_params(ep_size=16)`;
at the default ep_size 1 it keeps 40).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    moe_d_ff=512,
    vocab=49155,
    rope_theta=1e4,
    n_experts=40,
    top_k=8,
    moe_every=1,
    long_context="long_500k via SWA variant (long_window=8192)",
    optimizer="adamw",
)
