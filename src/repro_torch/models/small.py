"""The paper's three simulation models (Sec. VI footnote 6) as `nn.Module`s.

  MNIST : MLP 784 -> 128 ReLU -> 256 ReLU -> 10 softmax
  CIFAR : CNN 3x3x32 conv + 2x2 maxpool + 3x3x64 conv + 2x2 maxpool
          -> 128 ReLU -> 10 softmax
  SST-2 : embed(4000 -> 64) mean-pool -> 128 ReLU -> 1 sigmoid

Inputs keep the JAX package's layout at `forward` (images NHWC), so both
packages take the same arrays.  Training is functional: the trainer holds
the parameters as a dict and calls the module through
`torch.func.functional_call`.  `params_from_jax` turns the JAX package's
parameter pytree into such a dict (dense w is (in, out) there, conv w is
HWIO); `init_params` draws fresh parameters from a `torch.Generator` with
the JAX package's initialisation law (He-normal weights, zero biases).
"""
from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["SmallModel", "MnistMLP", "CifarCNN", "Sst2Text",
           "get_small_model", "params_from_jax"]


def _xent_per_example(logits, y):
    return -torch.log_softmax(logits, dim=-1).gather(-1, y[:, None].long())[:, 0]


class SmallModel(nn.Module):
    """Common surface: `forward(x) -> logits`, the per-example loss and the
    correctness of each prediction, given logits."""

    def loss_per_example(self, logits, y):
        return _xent_per_example(logits, y)

    def correct(self, logits, y):
        return (torch.argmax(logits, dim=-1) == y).to(torch.float32)

    def init_params(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """Fresh parameters: weights N(0, 1) * sqrt(2 / fan_in), biases 0
        (the JAX package's `_dense_init` / `conv_init`)."""
        out = {}
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                out[name] = torch.zeros_like(p)
                continue
            fan_in = p.shape[1] if p.ndim == 2 else math.prod(p.shape[1:])
            w = torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=p.dtype)
            out[name] = w * math.sqrt(2.0 / fan_in)
        return out


class MnistMLP(SmallModel):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(784, 128)
        self.fc2 = nn.Linear(128, 256)
        self.out = nn.Linear(256, 10)

    def forward(self, x):
        h = F.relu(self.fc1(x))
        h = F.relu(self.fc2(h))
        return self.out(h)


class CifarCNN(SmallModel):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 3, padding=1)
        self.conv2 = nn.Conv2d(32, 64, 3, padding=1)
        self.fc = nn.Linear(8 * 8 * 64, 128)
        self.out = nn.Linear(128, 10)

    def forward(self, x):                     # x: (B, 32, 32, 3), NHWC
        h = x.permute(0, 3, 1, 2)
        h = F.max_pool2d(F.relu(self.conv1(h)), 2)
        h = F.max_pool2d(F.relu(self.conv2(h)), 2)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # flatten as NHWC
        h = F.relu(self.fc(h))
        return self.out(h)


class Sst2Text(SmallModel):
    def __init__(self, vocab: int = 4000, d_embed: int = 64):
        super().__init__()
        self.embed = nn.Embedding(vocab, d_embed)
        self.fc = nn.Linear(d_embed, 128)
        self.out = nn.Linear(128, 1)

    def forward(self, x):                     # x: (B, seq) int tokens
        emb = self.embed(x.long()).mean(dim=1)
        h = F.relu(self.fc(emb))
        return self.out(h)[:, 0]

    def loss_per_example(self, logits, y):
        yf = y.to(torch.float32)
        # Stable binary cross-entropy with logits, per example.
        return (torch.clamp_min(logits, 0) - logits * yf
                + torch.log1p(torch.exp(-logits.abs())))

    def correct(self, logits, y):
        return ((logits > 0).to(torch.int32) == y).to(torch.float32)

    def init_params(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        out = super().init_params(generator)
        w = self.embed.weight
        out["embed.weight"] = torch.randn(w.shape, generator=generator,
                                          device=w.device, dtype=w.dtype) * 0.1
        return out


_MODELS = {"mnist": MnistMLP, "cifar10": CifarCNN, "sst2": Sst2Text}


def get_small_model(dataset: str) -> SmallModel:
    try:
        return _MODELS[dataset]()
    except KeyError:
        raise ValueError(f"no small model for dataset {dataset!r}") from None


def params_from_jax(params: Mapping, *, device=None) -> dict[str, torch.Tensor]:
    """The JAX package's parameter pytree (leaves as numpy arrays) -> this
    module's parameter dict: dense w (in, out) -> weight (out, in), conv w
    HWIO -> OIHW, embedding table unchanged."""
    out = {}
    for layer, leaves in params.items():
        if not isinstance(leaves, Mapping):        # the embedding table
            out[f"{layer}.weight"] = torch.tensor(
                np.asarray(leaves, dtype=np.float32), device=device)
            continue
        for leaf, value in leaves.items():
            a = np.asarray(value, dtype=np.float32)
            if leaf == "b":
                name = f"{layer}.bias"
            elif a.ndim == 4:
                name, a = f"{layer}.weight", a.transpose(3, 2, 0, 1)
            else:
                name, a = f"{layer}.weight", a.T
            out[name] = torch.tensor(np.ascontiguousarray(a), device=device)
    return out
