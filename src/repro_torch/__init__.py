"""PyTorch/CUDA port of the wireless-FL Stackelberg reproduction.

A second package beside the JAX package `repro`, with the same layout:
`core` (wireless model, Algorithm 1 on hand-written CUDA kernels, the
NumPy Stackelberg leader), `kernels` (each CUDA kernel beside its plain
torch version), `scenarios`, `data`, `models`, `train` and `fl` (the
simulation harness, host-loop engine).  It imports neither JAX nor `repro`.

Entry points run on CUDA unless called with device="cpu".
"""
