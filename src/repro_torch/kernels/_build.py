"""Build and load the port's CUDA kernels.

The sources in `repro_torch/csrc/` are compiled with `nvcc` on first use
into a shared library with a plain C interface and loaded with `ctypes`
(no PyTorch headers, so a build takes seconds).  The library lands in the
checkout's `build/kernels/` directory, named by a hash of its source and
flags, so an edited source is never served a stale build; nvcc's output
(with ptxas's register report) is kept beside it as `<library>.log`.

Nothing here runs at import: a CPU-only machine imports every module of
the port without `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

__all__ = ["load", "load_polyblock", "load_fedavg", "build_info", "check_launch",
           "count_launches", "check_no_grad", "nvcc_flags", "sass_opcodes", "LIBRARIES",
           "NVCC_FLAGS"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
# --fmad=false keeps every a*b+c as two rounded operations, so the float64
# Algorithm-1 kernels track the plain torch versions (and the JAX reference)
# bit for bit wherever log1p agrees, and K3 and K5 give their plain
# versions' bits.  The attention kernel is held to a tolerance and keeps
# the FMAs.
_EXTRA_FLAGS = {name: ("--fmad=false",) for name in ("polyblock", "fedavg_agg", "rwkv6_wkv")}

_P, _I32, _I64, _F64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
_F32 = ctypes.c_float
_FLASH = [_P] * 4 + [_I32] * 6 + [_F32, _I32, _I32, _P]
_WKV6 = [_P] * 8 + [_I32] * 4 + [_P]
_PROJECT = [_P] * 5 + [_I64, _I32, _I32] + [_F64] * 5 + [_P]
_SOLVE = [_P] * 8 + [_I64, _F64, _I32, _I32, _I32] + [_F64] * 6 + [_P]
# One library per source file csrc/<name>.cu: its C functions' argtypes.
_SIGNATURES = {
    "polyblock": {"polyblock_project_f64": _PROJECT, "polyblock_project_f32": _PROJECT,
                  "polyblock_solve_f64": _SOLVE, "polyblock_solve_f32": _SOLVE,
                  "polyblock_solve_max_iter": [_I32, _I32]},
    "fedavg_agg": {"fedavg_agg_leaves_f32": [_P, _I32, _P, _I32, _P],
                   "fedavg_agg_cells_f32": [_P, _I32, _P, _I32, _I32, _P],
                   "fedavg_agg_table_leaves": [], "fedavg_agg_max_cells": []},
    "flash_attention": {"flash_attention_f32": _FLASH, "flash_attention_bf16": _FLASH,
                        "flash_attention_bf16_smem_bytes": [_I32]},
    "rwkv6_wkv": {"wkv6_f32": _WKV6, "wkv6_threads_per_block": [_I32]},
}
LIBRARIES = tuple(_SIGNATURES)

# A lock per library, so two libraries can build at the same time.
_locks = {name: threading.Lock() for name in _SIGNATURES}
_libs: dict[str, ctypes.CDLL] = {}
_info: dict[str, dict] = {}


def _tool(name: str) -> str:
    """A CUDA toolkit program (nvcc, cuobjdump), from PATH or CUDA_HOME."""
    found = shutil.which(name)
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / name
    if not path.exists():
        raise RuntimeError(
            f"{name} not found (looked on PATH and under CUDA_HOME); the CUDA "
            "toolkit is needed to build the port's kernels")
    return str(path)


def nvcc_flags(name: str) -> tuple[str, ...]:
    """The nvcc flags library `name` is built with."""
    return NVCC_FLAGS + _EXTRA_FLAGS.get(name, ())


def _build(name: str, sources: list[Path]) -> Path:
    flags = nvcc_flags(name)
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.read_bytes())
    digest.update(" ".join(flags).encode())
    lib = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    log = lib.with_name(lib.name + ".log")
    if lib.exists():
        _info[name] = {"library": str(lib), "seconds": 0.0, "cached": True,
                       "log": log.read_text() if log.exists() else ""}
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_tool("nvcc"), *flags, "-o", tmp, *map(str, sources)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _info[name] = {"library": str(lib), "seconds": time.perf_counter() - t0,
                   "cached": False, "log": proc.stdout + proc.stderr}
    return lib


def load(name: str) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu (one of LIBRARIES), built on
    first call."""
    with _locks[name]:
        if name not in _libs:
            lib = ctypes.CDLL(str(_build(name, [_CSRC / f"{name}.cu"])))
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def load_polyblock() -> ctypes.CDLL:
    """The Algorithm-1 kernels (K1 solve, K2 project), built on first call."""
    return load("polyblock")


def load_fedavg() -> ctypes.CDLL:
    """The eq.-34 aggregation kernel (K3), built on first call."""
    return load("fedavg_agg")


def build_info(name: str = "polyblock") -> dict:
    """Library path, build seconds and nvcc's output (with `-Xptxas=-v`'s
    register and spill report) of the last build of `name`."""
    return dict(_info.get(name, {}))


def sass_opcodes(name: str, opcodes: tuple[str, ...]) -> dict[str, dict[str, int]]:
    """How often each of `opcodes` (e.g. "HGMMA") occurs in the SASS of
    every kernel of library `name`, by `cuobjdump -sass` of its built
    library: {mangled kernel name: {opcode: count}}.  Loads (and so builds)
    the library first."""
    load(name)
    out = subprocess.run([_tool("cuobjdump"), "-sass", _info[name]["library"]],
                         capture_output=True, text=True, check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    current = None
    for ln in out.splitlines():
        if "Function :" in ln:
            current = counts.setdefault(ln.split("Function :", 1)[1].strip(),
                                        dict.fromkeys(opcodes, 0))
        elif current is not None and "/*" in ln:
            words = ln.split("*/", 1)[-1].replace(";", " ").split()
            for op in opcodes:
                current[op] += sum(w == op or w.startswith(op + ".") for w in words)
    return counts


_count_lock = threading.Lock()


def count_launches(wrapper, n: int = 1) -> None:
    """Add n to `wrapper.launches`, the count of the kernel launches it made,
    under a lock: the simulation's shards launch from threads of their own
    (`launch.mesh.map_shards`)."""
    with _count_lock:
        wrapper.launches += n


def check_launch(err: int, what: str) -> None:
    """Raise on a non-zero `cudaGetLastError()` code returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def check_no_grad(what: str, *xs) -> None:
    """Raise if autograd would record a call of a kernel that has no
    backward: grad mode is on and an input requires grad.  The kernel's
    output would have no grad_fn, and a gradient through it would be
    silently dropped."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward, so it cannot run on inputs that "
            "require grad (the JAX package cannot differentiate its Pallas kernel either); "
            "use the config's 'ref' path, or call it under torch.no_grad()")
