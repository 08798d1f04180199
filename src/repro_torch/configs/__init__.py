"""Config registry of the port's model zoo: the families the port runs so
far (dense GQA: qwen2-7b; RWKV-6: rwkv6-7b), and their reduced smoke
variants via the `-smoke` suffix (`ArchConfig.reduced()`)."""
from .base import INPUT_SHAPES, ArchConfig, InputShape
from .qwen2_7b import CONFIG as qwen2_7b
from .rwkv6_7b import CONFIG as rwkv6_7b

ARCHS: dict[str, ArchConfig] = {c.name: c for c in (qwen2_7b, rwkv6_7b)}

# The JAX package's other architectures: their families (MoE, MLA,
# hybrid/Mamba, audio, VLM) are still to port.
STILL_TO_PORT = ("deepseek-v3-671b", "granite-moe-3b-a800m", "qwen1.5-110b",
                 "whisper-base", "stablelm-3b", "yi-6b", "jamba-v0.1-52b",
                 "qwen2-vl-2b")


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    if name in ARCHS:
        return ARCHS[name]
    if name in STILL_TO_PORT:
        raise ValueError(f"arch {name!r} is still to port to PyTorch (ROADMAP.md, "
                         f"Queue 1 'LLM zoo'); the port runs {sorted(ARCHS)}")
    raise ValueError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")


__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "ARCHS", "STILL_TO_PORT",
           "get_config"]
