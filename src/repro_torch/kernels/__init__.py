"""Hand-written CUDA kernels of the port, each beside its plain torch
version.

  polyblock_project -- K2: the 60-step bisection projection (eqs. 27-29);
  polyblock_fused   -- K1: all of Algorithm 1 in one kernel;
  fedavg_agg        -- K3: the eq.-34 weighted mean of the server;
  flash_attention   -- K4: causal / sliding-window GQA attention (prefill of
                       the model zoo's attention layers);
  rwkv6_wkv         -- K5: the RWKV-6 WKV recurrence (prefill and decode).

A wrapper launches its kernel for a CUDA tensor and runs the plain version
only for a CPU tensor; each counts its launches in `wrapper.launches`.
The CUDA sources live in `repro_torch/csrc/` and are built on first use
(`kernels._build`).
"""
from .flash_attention import flash_attention, flash_attention_plain
from .rwkv6_wkv import wkv6, wkv6_plain

__all__ = ["flash_attention", "flash_attention_plain", "wkv6", "wkv6_plain"]
