"""Builds the package's CUDA kernels and loads them with ctypes.

Every `csrc/*.cu` file compiles with nvcc into an object of its own, all at
once in parallel, and the objects link into one shared library with a plain
C interface, at first use, into `build/torch_kernels/` of the checkout.
The file name carries a hash of every file under `csrc/` (the shared
headers `*.cuh` included) and of the flags, so an edited source or header
builds anew and an unchanged tree loads at once.  Nothing here runs at
import: the CPU tests import every module on a machine with no CUDA
toolkit.
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

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
# no --use_fast_math; -fmad=false keeps a*b+c as two roundings, as the
# plain PyTorch versions compute it
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-fmad=false", "-std=c++17",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC,
]

_ptr = ctypes.c_void_p
_int = ctypes.c_int

# argument types of each entry point (csrc/*.cu, `extern "C"`)
_SIGNATURES = {
    "crt_closest_hit": [
        _ptr, _ptr, _ptr, _ptr, _int,  # o, d, t0, mask, n
        _ptr, _ptr, _ptr, _ptr, _int, _int,  # node records, tris4, shade, slot ids, record
        #                                      root, leaf code form
        *[_ptr] * 9,  # t, u, v, slot, tri, obj, mat, traversed, tested
        _ptr,  # stream
    ],
    "crt_occluded": [
        _ptr, _ptr, _ptr, _ptr, _int,  # o, d, t0, mask, n
        _ptr, _ptr, _int, _int,  # node records, tris4, record root, leaf code form
        _ptr, _ptr,  # occluded, stream
    ],
    "crt_closest_hit_links": [
        _ptr, _ptr, _ptr, _ptr, _int,  # o, d, t0, mask, n
        _ptr, _int, _ptr, _ptr, _ptr, _int, _int,  # link records, node count, tris4, shade,
        #                                            slot ids, root, leaf code form
        *[_ptr] * 9,  # t, u, v, slot, tri, obj, mat, traversed, tested
        _ptr,  # stream
    ],
    "crt_occluded_links": [
        _ptr, _ptr, _ptr, _ptr, _int,  # o, d, t0, mask, n
        _ptr, _int, _ptr, _int, _int,  # link records, node count, tris4, root, leaf code form
        _ptr, _ptr,  # occluded, stream
    ],
    "crt_closest_hit_wide": [
        _ptr, _ptr, _ptr, _ptr, _int,  # o, d, t0, mask, n
        _ptr, _ptr, _int, _ptr, _ptr, _ptr, _int,  # wide records, wide roots, n_roots, tris4,
        #                                            shade, slot ids, leaf code form
        _ptr,  # perm
        *[_ptr] * 9,  # t, u, v, slot, tri, obj, mat, traversed, tested
        _ptr,  # stream
    ],
    "crt_occluded_wide": [
        _ptr, _ptr, _ptr, _ptr, _int,  # o, d, t0, mask, n
        _ptr, _ptr, _int, _ptr, _int,  # wide records, wide roots, n_roots, tris4, leaf code form
        _ptr,  # perm
        _ptr, _ptr,  # occluded, stream
    ],
    "crt_wavefront_pt": [
        _ptr, _ptr, _ptr, _ptr, _ptr, _int,  # o, d, seed, alive, inside, n
        _ptr, _int, _int, _int, _int, _ptr,  # walk records, node count, root, links, leaf
        #                                      code form, tris4
        _ptr, _ptr, _int,  # shade, params, n_mats
        _int, _int, _int,  # k_depths, depth_limit, depth_base
        _ptr,  # perm
        *[_ptr] * 13,  # tp, o, d, seed, missed, lit, alive, inside, tex, locus,
        #                traversed, tested, live
        _ptr,  # stream
    ],
    "crt_whitted_wf": [
        _ptr, _ptr, _ptr, _ptr, _int,  # o, d, alive, inside, n
        _ptr, _int, _int, _int, _int, _ptr,  # walk records, node count, root, links, leaf
        #                                      code form, tris4
        _ptr, _ptr, _int, _int,  # shade, params, n_mats, shadow_quirk
        _ptr,  # perm
        *[_ptr] * 10,  # t, flags, mat, tex, irr, r_dir, t_dir, fr, traversed, tested
        _ptr,  # stream
    ],
    "crt_vpu_leaf": [
        _ptr, _int,  # tris, n_tris
        *[_ptr] * 6, _int,  # ox, oy, oz, dx, dy, dz, n
        _ptr, _ptr,  # out, stream
    ],
    "crt_mxu_leaf": [
        _ptr, _ptr, _int, _int,  # C in fragment order, phi ray-major, n_tiles, m
        _ptr, _ptr,  # out, stream
    ],
    "crt_sync_probe": [
        _ptr, _int,  # node records, m
        *[_ptr] * 6, _int, _int,  # ox, oy, oz, dx, dy, dz, n_tiles, variant
        _ptr, _ptr,  # out, stream
    ],
}


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


def library_path() -> str:
    """Where the library of the current sources and flags is built: the
    digest covers every file under `csrc/`, by name and content."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "**", "*"), recursive=True)):
        if os.path.isfile(path):
            digest.update(os.path.relpath(path, CSRC).encode())
            with open(path, "rb") as f:
                digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libcrt_kernels_{digest.hexdigest()[:16]}.so")


def _build(path: str) -> tuple[float, str]:
    """One nvcc per source, started together, then one link."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = f"{path}.{os.getpid()}"
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    start = time.perf_counter()
    objects, procs = [], []
    for src in sources:
        obj = f"{stem}.{os.path.basename(src)}.o"
        objects.append(obj)
        procs.append(subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    failed = [src for src, p in zip(sources, procs) if p.returncode != 0]
    if not failed:
        link = subprocess.run(
            [_nvcc(), "-shared", "-o", f"{stem}.tmp", *objects],
            capture_output=True, text=True,
        )
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed = ["link"]
    for obj in objects:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    os.replace(f"{stem}.tmp", path)
    return time.perf_counter() - start, log


@functools.lru_cache(maxsize=None)
def load() -> KernelLibrary:
    path = library_path()
    seconds, log = 0.0, ""
    if not os.path.isfile(path):
        seconds, log = _build(path)
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = _int
        fn.argtypes = argtypes
    lib.crt_error_string.restype = ctypes.c_char_p
    lib.crt_error_string.argtypes = [_int]
    return KernelLibrary(lib, path, seconds, log)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} ({lib.crt_error_string(code).decode()})")


def ptr(x) -> int | None:
    """Device pointer of a tensor, or None (a null pointer) for None."""
    return None if x is None else x.data_ptr()


def on_cpu(what: str, x: torch.Tensor) -> bool:
    """True for a CPU tensor (the wrapper runs the plain version), False for
    a CUDA tensor (it launches the kernel); raises for any other device."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return False


def require_aligned(what: str, **tensors) -> None:
    """Raise unless every tensor's data starts on a 16-byte boundary, as
    the kernels' vector loads of `int4` / `float4` records need (a view at
    an offset may not)."""
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned (data_ptr {x.data_ptr():#x})")


def require(what: str, device, **tensors) -> None:
    """Raise unless every `name=(tensor, dtype, shape or None)` is a
    contiguous tensor of that dtype (and shape) on `device` that autograd
    does not track (a kernel reads its pointer, outside the graph); a None
    tensor is an absent optional input."""
    for name, (x, dtype, shape) in tensors.items():
        if x is None:
            continue
        if x.requires_grad:
            raise ValueError(f"{what}: {name} requires grad; kernels take detached tensors")
        if x.device != device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(
                f"{what}: {name} must be a contiguous {dtype} tensor on {device}, "
                f"got {x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
            )
        if shape is not None and tuple(x.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(x.shape)}, expected {shape}")


def stream(device) -> int:
    """The handle of PyTorch's current stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream
