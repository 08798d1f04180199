"""K5: the RWKV-6 WKV recurrence — the wrapper of the CUDA kernel.

  wkv6       -- r, k, v, w (B, T, H, hs), u (H, hs), state (B, H, hs, hs),
                all f32 -> (y (B, T, H, hs), final state): the wrapper of
                `wkv6_kernel` (csrc/rwkv6_wkv.cu), which replaces the Pallas
                kernel `kernels/rwkv6_wkv/kernel.py::_wkv6_kernel`; the
                signature of the JAX package's `wkv6_scan_ref`, for any
                T >= 1 (prefill and the T = 1 decode step);
  wkv6_plain -- the plain torch version (`.ref`).

A CUDA tensor launches the kernel; a CPU tensor runs the plain version; a
meta tensor (the dry run, `launch/dryrun.py`) gets the kernel's outputs as
shapes, as a custom op's meta function gives them: nothing is computed or
launched.
"""
from __future__ import annotations

import torch

from .._build import check_launch, check_no_grad, count_launches, load
from .ref import wkv6_plain

__all__ = ["wkv6", "wkv6_plain", "HEAD_SIZES"]

HEAD_SIZES = (32, 64)


def wkv6(r, k, v, w, u, state):
    """Same semantics as `wkv6_plain`.  On the card every argument is a
    contiguous float32 tensor on one device, with hs in HEAD_SIZES and
    T >= 1; anything else raises, as does a call that autograd would
    record (an input requires grad): the kernel has no backward."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, state)
    if r.device.type == "meta":
        return torch.empty_like(r), torch.empty_like(state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: unsupported device {r.device}")
    check_no_grad("wkv6", r, k, v, w, u, state)
    if r.ndim != 4:
        raise ValueError(f"wkv6: r must be (B, T, H, hs), got {tuple(r.shape)}")
    b, t, h, hs = r.shape
    shapes = {"r": (b, t, h, hs), "k": (b, t, h, hs), "v": (b, t, h, hs),
              "w": (b, t, h, hs), "u": (h, hs), "state": (b, h, hs, hs)}
    for name, x in zip(shapes, (r, k, v, w, u, state)):
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"wkv6: {name} has shape {tuple(x.shape)}, "
                             f"expected {shapes[name]}")
        if x.dtype != torch.float32 or x.device != r.device:
            raise ValueError(f"wkv6: {name} must be float32 on {r.device}, "
                             f"got {x.dtype} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"wkv6: {name} is not contiguous")
    if hs not in HEAD_SIZES:
        raise ValueError(f"wkv6: head size {hs} not in {HEAD_SIZES}")
    if t < 1 or b * h < 1:
        raise ValueError(f"wkv6: needs T >= 1 and B*H >= 1, got T={t}, B*H={b * h}")
    y = torch.empty_like(r)
    s_out = torch.empty_like(state)
    lib = load("rwkv6_wkv")
    with torch.cuda.device(r.device):
        err = lib.wkv6_f32(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                           u.data_ptr(), state.data_ptr(), y.data_ptr(), s_out.data_ptr(),
                           b, t, h, hs, torch.cuda.current_stream(r.device).cuda_stream)
    check_launch(err, "wkv6")
    count_launches(wkv6)
    return y, s_out


wkv6.launches = 0
