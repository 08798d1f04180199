"""K4: flash attention — the wrapper of the CUDA kernel.

  flash_attention       -- q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D) in the
                           model's layout -> (B, Sq, Hq, D): the wrapper of
                           csrc/flash_attention.cu's kernels,
                           `flash_fwd_bf16_wgmma` (bf16, tensor cores) and
                           `flash_fwd_kernel` (f32), which replace the Pallas
                           kernel
                           `kernels/flash_attention/kernel.py::flash_attention_kernel`;
  flash_attention_plain -- the plain torch version (`.ref`).

A CUDA tensor launches the kernel; a CPU tensor runs the plain version.
"""
from __future__ import annotations

import torch

from .._build import check_launch, check_no_grad, count_launches, load
from .ref import flash_attention_plain

__all__ = ["flash_attention", "flash_attention_plain", "HEAD_DIMS"]

HEAD_DIMS = (64, 80, 128)     # 80: stablelm-3b (2560 / 32)
_ENTRY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Causal (or full) attention with an optional sliding window, queries
    right-aligned to the keys, softmax scale D**-0.5, f32 accumulation,
    output in q's dtype.

    On the card q, k and v are contiguous, of one dtype (bf16 or f32) and on
    one device, with D in HEAD_DIMS (64, 80 or 128), Hq a multiple of Hkv
    and Sq <= Sk; in bf16 they also start on a 16-byte boundary (the kernel
    reads them by TMA); anything else raises, as does a call that autograd
    would record (an input requires grad): the kernel has no backward."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    check_no_grad("flash_attention", q, k, v)
    if q.dtype not in _ENTRY:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported "
                         "(bfloat16 or float32)")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.ndim != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D (B, S, H, D), "
                             f"got {tuple(x.shape)}")
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash_attention: {name} is {x.dtype} on {x.device}, "
                             f"q is {q.dtype} on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
        if x.dtype == torch.bfloat16 and x.data_ptr() % 16:
            raise ValueError(f"flash_attention: bf16 {name} does not start on a 16-byte "
                             "boundary, which the kernel's TMA loads need")
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of Hkv={hkv}")
    if sq > sk:
        raise ValueError(f"flash_attention: Sq={sq} > Sk={sk}")
    if b * hq > 65535:
        raise ValueError(f"flash_attention: B*Hq={b * hq} exceeds the grid's 65535")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = load("flash_attention")
    with torch.cuda.device(q.device):
        err = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk, hq, hkv, d,
            d**-0.5, int(causal), int(window), torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, "flash_attention")
    count_launches(flash_attention)
    return out


flash_attention.launches = 0
