"""Build and load the port's CUDA kernels.

The sources in `repro_torch/csrc/` are compiled with `nvcc` on first use
into a shared library with a plain C interface and loaded with `ctypes`
(no PyTorch headers, so a build takes seconds).  The library lands in the
checkout's `build/kernels/` directory, named by a hash of its source and
flags, so an edited source is never served a stale build.

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

__all__ = ["load_polyblock", "load_fedavg", "build_info", "check_launch",
           "NVCC_FLAGS"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# --fmad=false keeps every a*b+c as two rounded operations, so the float64
# kernels track the plain torch versions (and the JAX reference) bit for bit
# wherever log1p agrees.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_P, _I32, _I64, _F64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
_PROJECT = [_P] * 5 + [_I64, _I32] + [_F64] * 5 + [_P]
_SOLVE = [_P] * 8 + [_I64, _F64, _I32, _I32] + [_F64] * 6 + [_P]
# One library per source file csrc/<name>.cu: its C functions' argtypes.
_SIGNATURES = {
    "polyblock": {"polyblock_project_f64": _PROJECT, "polyblock_project_f32": _PROJECT,
                  "polyblock_solve_f64": _SOLVE, "polyblock_solve_f32": _SOLVE},
    "fedavg_agg": {"fedavg_agg_f32": [_P, _P, _P, _I32, _I64, _P]},
}

# A lock per library, so two libraries can build at the same time.
_locks = {name: threading.Lock() for name in _SIGNATURES}
_libs: dict[str, ctypes.CDLL] = {}
_info: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and under CUDA_HOME); the CUDA "
            "toolkit is needed to build the port's kernels")
    return str(path)


def _build(name: str, sources: list[Path]) -> Path:
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        _info[name] = {"library": str(lib), "seconds": 0.0, "cached": True, "log": ""}
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _info[name] = {"library": str(lib), "seconds": time.perf_counter() - t0,
                   "cached": False, "log": proc.stdout + proc.stderr}
    return lib


def _load(name: str) -> ctypes.CDLL:
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
    return _load("polyblock")


def load_fedavg() -> ctypes.CDLL:
    """The eq.-34 aggregation kernel (K3), built on first call."""
    return _load("fedavg_agg")


def build_info(name: str = "polyblock") -> dict:
    """Library path, build seconds and nvcc's output (with `-Xptxas=-v`'s
    register and spill report) of the last build of `name`."""
    return dict(_info.get(name, {}))


def check_launch(err: int, what: str) -> None:
    """Raise on a non-zero `cudaGetLastError()` code returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
