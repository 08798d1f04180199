"""Checkpoints of the model zoo's trees in the JAX package's `.npz` layout
(`ckpt.py`)."""
from .ckpt import restore_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "restore_checkpoint"]
