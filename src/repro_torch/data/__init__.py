"""Seeded synthetic MNIST / CIFAR-10 / SST-2 stand-ins and the paper's
partitions (NumPy copy of the JAX package's `data/fl_datasets.py`)."""
from .fl_datasets import (Dataset, FLPartition, cifar_like, make_dataset,
                          mnist_like, partition_dirichlet,
                          partition_imbalanced_iid, sst2_like)

__all__ = ["Dataset", "FLPartition", "make_dataset", "mnist_like",
           "cifar_like", "sst2_like", "partition_imbalanced_iid",
           "partition_dirichlet"]
