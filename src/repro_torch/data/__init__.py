"""Seeded synthetic MNIST / CIFAR-10 / SST-2 stand-ins and the paper's
partitions (NumPy copy of the JAX package's `data/fl_datasets.py`), and
the model zoo's synthetic token batches and stream (`pipeline.py`)."""
from .fl_datasets import (Dataset, FLPartition, cifar_like, make_dataset,
                          mnist_like, partition_dirichlet,
                          partition_imbalanced_iid, sst2_like)
from .pipeline import synthetic_lm_stream, synthetic_token_batch

__all__ = ["Dataset", "FLPartition", "make_dataset", "mnist_like",
           "cifar_like", "sst2_like", "partition_imbalanced_iid",
           "partition_dirichlet", "synthetic_token_batch", "synthetic_lm_stream"]
