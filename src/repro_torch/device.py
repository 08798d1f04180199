"""Device resolution shared by the port's entry points.

The port runs on CUDA unless the caller asks for the CPU: `device=None`
means the current CUDA device, and with no card visible that is an error,
never a quiet move to the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` -> the current CUDA device (raises without one); otherwise
    the named device, which must be "cuda[:i]" or "cpu"."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the port "
                "on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    return device
