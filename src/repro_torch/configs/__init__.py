"""Config registry of the port's model zoo: the JAX package's ten
architectures (dense GQA: qwen2-7b, stablelm-3b, yi-6b, qwen1.5-110b;
GQA + MoE: granite-moe-3b-a800m; RWKV-6: rwkv6-7b; MLA + MoE with the MTP
head: deepseek-v3-671b; Mamba + GQA + MoE: jamba-v0.1-52b; the audio
encoder-decoder: whisper-base; the VLM with M-RoPE: qwen2-vl-2b), and their
reduced smoke variants via the `-smoke` suffix (`ArchConfig.reduced()`)."""
from .base import INPUT_SHAPES, ArchConfig, InputShape
from .deepseek_v3_671b import CONFIG as deepseek_v3_671b
from .granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from .jamba_v0_1_52b import CONFIG as jamba_v0_1_52b
from .qwen1_5_110b import CONFIG as qwen1_5_110b
from .qwen2_7b import CONFIG as qwen2_7b
from .qwen2_vl_2b import CONFIG as qwen2_vl_2b
from .rwkv6_7b import CONFIG as rwkv6_7b
from .stablelm_3b import CONFIG as stablelm_3b
from .whisper_base import CONFIG as whisper_base
from .yi_6b import CONFIG as yi_6b

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in (qwen2_7b, rwkv6_7b, stablelm_3b, yi_6b, qwen1_5_110b,
                        granite_moe_3b_a800m, deepseek_v3_671b, jamba_v0_1_52b,
                        whisper_base, qwen2_vl_2b)}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    try:
        return ARCHS[name]
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}") from None


__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "ARCHS", "get_config"]
