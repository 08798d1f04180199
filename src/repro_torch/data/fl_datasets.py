"""Federated datasets + the paper's imbalanced-IID partition (Sec. VI).

MNIST / CIFAR-10 / SST-2 are not downloadable in this offline container, so
we generate *seeded synthetic* datasets with identical tensor shapes, class
counts and sizes (DESIGN.md §5).  Samples are drawn from class-conditional
distributions so the paper's models actually learn and the scheme ordering
of Figs. 3-9 is reproducible:

  mnist_like : 28x28 grayscale, 10 classes — class prototype blobs + noise.
  cifar_like : 32x32x3, 10 classes — low-freq class textures + noise.
  sst2_like  : token sequences (len 32, vocab 4000), 2 classes — class-tilted
               unigram distributions over a shared vocabulary.

Partition: the paper's imbalanced IID — c_n ~ U[1, 10] per device, shuffled
samples split by fraction c_n / sum_i c_i.
"""
from __future__ import annotations

import dataclasses
import numpy as np

__all__ = [
    "Dataset",
    "FLPartition",
    "mnist_like",
    "cifar_like",
    "sst2_like",
    "make_dataset",
    "partition_imbalanced_iid",
]


@dataclasses.dataclass(frozen=True)
class Dataset:
    name: str
    x: np.ndarray        # (n, ...) float32 inputs or int32 tokens
    y: np.ndarray        # (n,) int32 labels
    n_classes: int

    @property
    def n(self) -> int:
        return int(self.x.shape[0])


@dataclasses.dataclass(frozen=True)
class FLPartition:
    """Per-device sample index lists + sizes beta_n."""

    indices: tuple[np.ndarray, ...]   # len N, each (beta_n,)
    beta: np.ndarray                  # (N,) int64

    @property
    def n_devices(self) -> int:
        return len(self.indices)


def mnist_like(rng: np.random.Generator, n: int = 500) -> Dataset:
    """28x28 digits stand-in: 10 Gaussian-blob prototypes + pixel noise."""
    protos = rng.normal(0.0, 1.0, size=(10, 28, 28)).astype(np.float32)
    # Smooth prototypes a little so classes are separable but not trivial.
    k = np.ones((5, 5), np.float32) / 25.0
    sm = np.stack([_conv2d_same(p, k) for p in protos])
    y = rng.integers(0, 10, size=n).astype(np.int32)
    x = sm[y] + rng.normal(0.0, 0.6, size=(n, 28, 28)).astype(np.float32)
    return Dataset("mnist_like", x.reshape(n, 784), y, 10)


def cifar_like(rng: np.random.Generator, n: int = 2000) -> Dataset:
    """32x32x3 stand-in: low-frequency class textures + noise.

    The paper trains on 50k CIFAR images; the simulation default is reduced
    (configurable) so benchmark sweeps finish on CPU.
    """
    freqs = rng.uniform(0.5, 3.0, size=(10, 2))
    phases = rng.uniform(0, 2 * np.pi, size=(10, 3))
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32.0
    protos = np.stack(
        [
            np.stack(
                [
                    np.sin(2 * np.pi * (f[0] * xx + f[1] * yy) + ph[c])
                    for c in range(3)
                ],
                axis=-1,
            )
            for f, ph in zip(freqs, phases)
        ]
    ).astype(np.float32)
    y = rng.integers(0, 10, size=n).astype(np.int32)
    x = protos[y] + rng.normal(0.0, 0.8, size=(n, 32, 32, 3)).astype(np.float32)
    return Dataset("cifar_like", x, y, 10)


def sst2_like(
    rng: np.random.Generator, n: int = 2000, vocab: int = 4000, seq: int = 32
) -> Dataset:
    """Binary sentiment stand-in: class-tilted unigram token draws.

    A shared Zipf-ish base distribution; each class boosts a disjoint set of
    'sentiment' tokens, mimicking bag-of-words separability.
    """
    base = 1.0 / (np.arange(1, vocab + 1) ** 1.1)
    cls_tokens = rng.choice(vocab, size=(2, 100), replace=False)
    probs = np.stack([base.copy(), base.copy()])
    for c in range(2):
        probs[c, cls_tokens[c]] *= 40.0
    probs /= probs.sum(axis=1, keepdims=True)
    y = rng.integers(0, 2, size=n).astype(np.int32)
    x = np.stack([rng.choice(vocab, size=seq, p=probs[c]) for c in y]).astype(np.int32)
    return Dataset("sst2_like", x, y, 2)


_MAKERS = {"mnist": mnist_like, "cifar10": cifar_like, "sst2": sst2_like}


def make_dataset(name: str, rng: np.random.Generator, **kw) -> Dataset:
    try:
        return _MAKERS[name](rng, **kw)
    except KeyError:
        raise ValueError(f"unknown dataset {name!r}; choose from {sorted(_MAKERS)}")


def partition_imbalanced_iid(
    rng: np.random.Generator, n_samples: int, n_devices: int
) -> FLPartition:
    """Paper Sec. VI: c_n ~ U[1,10]; shuffled samples split by c_n/sum c."""
    c = rng.uniform(1.0, 10.0, size=n_devices)
    frac = c / c.sum()
    counts = np.maximum(1, np.floor(frac * n_samples).astype(np.int64))
    # Fix rounding so the counts sum to <= n_samples.
    while counts.sum() > n_samples:
        counts[np.argmax(counts)] -= 1
    perm = rng.permutation(n_samples)
    splits = np.cumsum(counts)[:-1]
    idx = tuple(np.array(a) for a in np.split(perm[: counts.sum()], splits))
    return FLPartition(indices=idx, beta=counts)


def partition_dirichlet(
    rng: np.random.Generator,
    labels: np.ndarray,
    n_devices: int,
    alpha: float = 0.5,
) -> FLPartition:
    """Label-skewed NON-IID partition (Dirichlet over class proportions).

    Beyond-paper extension: the paper evaluates imbalanced IID only; AoU
    weighting matters *more* under label skew (each device's update is more
    distinctive, so staleness costs more) — examples/non_iid_aou.py
    demonstrates this with the same harness.
    """
    n_classes = int(labels.max()) + 1
    idx_by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    for idx in idx_by_class:
        rng.shuffle(idx)
    device_bins: list[list[np.ndarray]] = [[] for _ in range(n_devices)]
    for c, idx in enumerate(idx_by_class):
        props = rng.dirichlet(np.full(n_devices, alpha))
        counts = np.floor(props * len(idx)).astype(np.int64)
        counts[-1] = len(idx) - counts[:-1].sum()
        start = 0
        for dev, cnt in enumerate(counts):
            device_bins[dev].append(idx[start : start + cnt])
            start += cnt
    indices = []
    for bins in device_bins:
        merged = np.concatenate(bins) if bins else np.array([], np.int64)
        if merged.size == 0:  # guarantee beta_n >= 1
            merged = np.array([int(rng.integers(len(labels)))], np.int64)
        indices.append(merged)
    beta = np.array([len(i) for i in indices], np.int64)
    return FLPartition(indices=tuple(indices), beta=beta)


def _conv2d_same(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Tiny same-padding 2-D convolution for prototype smoothing."""
    kh, kw = k.shape
    ph, pw = kh // 2, kw // 2
    pad = np.pad(img, ((ph, ph), (pw, pw)), mode="edge")
    out = np.zeros_like(img)
    for i in range(kh):
        for j in range(kw):
            out += k[i, j] * pad[i : i + img.shape[0], j : j + img.shape[1]]
    return out
