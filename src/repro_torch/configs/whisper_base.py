"""whisper-base [audio] — enc-dec, conv/mel frontend STUBBED.
[arXiv:2212.04356]

Assigned spec: 6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865.  The
mel-spectrogram + conv feature extractor is a stub: input_specs() provides
precomputed frame embeddings (B, 1500, 512).  6 encoder + 6 decoder layers;
decoder layers carry cross-attention to the encoder output.  Backbone uses
RoPE in place of whisper's learned absolute positions (DESIGN.md §5).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    rope_theta=1e4,
    is_encoder_decoder=True,
    n_encoder_layers=6,
    encoder_seq=1500,
    long_context="long_500k via SWA variant (long_window=8192)",
    optimizer="adamw",
)
