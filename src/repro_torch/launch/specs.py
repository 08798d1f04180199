"""Meta-device stand-ins for every model input (the PyTorch port's copy of
the JAX package's `launch/specs.py`): tensors on `torch.device("meta")`
with the shapes and dtypes of the JAX package's ShapeDtypeStructs, which
the dry run (`launch/dryrun.py`) runs the steps on (no storage).

As in the JAX package the modality frontends are stubs: the audio family
gets precomputed conv-frontend frame embeddings, the VLM family patch
embeddings and 3-D M-RoPE position ids.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig, InputShape

__all__ = ["META", "input_specs", "decode_input_specs", "cache_specs"]

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _family_extras(cfg: ArchConfig, batch: int, seq: int) -> dict:
    ex = {}
    if cfg.family == "audio":
        ex["enc_frames"] = _spec((batch, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm":
        ex["image_embeds"] = _spec((batch, cfg.n_patches, cfg.d_model), torch.bfloat16)
        ex["mrope_pos"] = _spec((batch, seq, 3), torch.int32)
    return ex


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Inputs for the train step / prefill step: the full-sequence batch.

    fl_weights carries the paper's per-cohort selection weights
    (alpha_n * beta_n * S_n * psi_n) — see DESIGN.md §2.
    """
    b, s = shape.global_batch, shape.seq_len
    specs = {
        "tokens": _spec((b, s), torch.int32),
        **_family_extras(cfg, b, s),
    }
    if shape.kind == "train":
        specs["labels"] = _spec((b, s), torch.int32)
        specs["fl_weights"] = _spec((b,), torch.float32)
    return specs


def decode_input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Inputs for the serve step: ONE new token against a seq_len-deep cache."""
    b = shape.global_batch
    specs = {
        "token": _spec((b, 1), torch.int32),
        "pos": _spec((), torch.int32),
    }
    if cfg.family == "vlm":
        specs["mrope_pos"] = _spec((b, 1, 3), torch.int32)
    return specs


def cache_specs(cfg: ArchConfig, shape: InputShape):
    """The decode cache of a seq_len-deep context on the meta device
    (`models.transformer.init_cache`; an encoder-decoder's holds its
    encoder output)."""
    from ..models.transformer import init_cache

    b, s = shape.global_batch, shape.seq_len
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = _spec((b, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
    return init_cache(cfg, b, s, META, enc_out=enc_out)
