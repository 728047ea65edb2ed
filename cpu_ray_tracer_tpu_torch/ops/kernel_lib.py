"""Builds the package's CUDA kernels and loads them with ctypes.

Every `csrc/*.cu` file compiles with nvcc into one shared library with a
plain C interface, at first use, into `build/torch_kernels/` of the
checkout.  The file name carries a hash of the sources and the flags, so
an edited source builds anew and an unchanged one loads at once.  Nothing
here runs at import: the CPU tests import every module on a machine with
no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import glob
import hashlib
import os
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
# no --use_fast_math; -fmad=false keeps a*b+c as two roundings, as the
# plain PyTorch versions compute it
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-fmad=false", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_ptr = ctypes.c_void_p
_int = ctypes.c_int


@dataclasses.dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when an existing build was loaded
    build_log: str  # nvcc's output, register and spill counts included


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: the CUDA kernels need nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


@functools.lru_cache(maxsize=None)
def load() -> KernelLibrary:
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    path = os.path.join(BUILD_DIR, f"libcrt_kernels_{digest.hexdigest()[:16]}.so")
    seconds, log = 0.0, ""
    if not os.path.isfile(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        start = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - start
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    lib.crt_closest_hit.restype = _int
    lib.crt_closest_hit.argtypes = [
        _ptr, _ptr, _ptr, _ptr, _int,  # o, d, t0, mask, n
        _ptr, _ptr, _ptr, _int,  # nodes, tris, shade, root
        *[_ptr] * 9,  # t, u, v, slot, tri, obj, mat, traversed, tested
        _ptr,  # stream
    ]
    lib.crt_error_string.restype = ctypes.c_char_p
    lib.crt_error_string.argtypes = [_int]
    return KernelLibrary(lib, path, seconds, log)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} ({lib.crt_error_string(code).decode()})")
