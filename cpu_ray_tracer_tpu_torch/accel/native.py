"""The native (C++) host-side BVH builders, bound with ctypes: the port of
the JAX package's `cpu_ray_tracer_tpu/accel/native.py`.

The library builds at first use from the port's own copy of the sources,
`native/crt_native.cpp`, with g++ into `build/torch_native/` of the
checkout.  Its file name hashes the source, the flags and the host's CPU
(`-march=native` code runs on the CPU it was built for), so an edited
source builds anew and an unchanged one loads at once.  Each build writes
its own temporary file and renames it, so processes building at once do
not collide.  Nothing is built at import.

The flags are exactly those of the JAX package's `native/Makefile`.  They
decide the trees: the SAH costs are float32, and other flags (no
`-march=native`, or `-ffp-contract=off`) contract other products into
fused multiply-adds, which pick other split planes.  With these flags the
port builds on any host the trees the JAX package builds on that host.

A failed g++ raises with its output: there is no silent fallback to the
numpy builder.  `build_sbvh_native` returns None where a node or
reference cap trips, as the JAX package's does (the SBVH's defined
behaviour: the caller builds the plain SAH tree instead).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
import time

import numpy as np

from cpu_ray_tracer_tpu_torch.accel.types import BuildStats, HostBVH

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "crt_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_native")
CXX = "g++"
# the JAX package's native/Makefile, flag for flag (module docstring)
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


@dataclasses.dataclass
class NativeLibrary:
    lib: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when an existing build was loaded


def cpu_flags() -> str:
    """The host CPU's feature flags (the `flags` line of /proc/cpuinfo; ""
    where there is none)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


def has_fma() -> bool:
    """Whether the host CPU has fused multiply-adds, which `-march=native`
    then uses (module docstring)."""
    return "fma" in cpu_flags().split()


def library_path() -> str:
    """Where the library of the current source, compiler, flags and CPU is
    built."""
    digest = hashlib.sha256(" ".join([CXX, *CXXFLAGS, cpu_flags()]).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libcrt_native_{digest.hexdigest()[:16]}.so")


def _build(path: str) -> float:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    start = time.perf_counter()
    try:
        out = subprocess.run([CXX, *CXXFLAGS, "-shared", "-o", tmp, SOURCE],
                             capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"{CXX} failed to start: {e}") from e
    if out.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{CXX} failed (exit {out.returncode}) on {SOURCE}:\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, path)
    return time.perf_counter() - start


@functools.lru_cache(maxsize=None)
def load() -> NativeLibrary:
    """The library, built first where it is missing; raises where g++
    fails."""
    path = library_path()
    seconds = 0.0 if os.path.isfile(path) else _build(path)
    lib = ctypes.CDLL(path)
    lib.crt_build_bvh.restype = ctypes.c_int
    lib.crt_build_bvh.argtypes = [
        _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _f32p, _f32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,
        np.ctypeslib.ndpointer(np.int32, shape=(1,)),
    ]
    lib.crt_build_sbvh.restype = ctypes.c_int
    lib.crt_build_sbvh.argtypes = [
        _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, _f32p, _f32p, _i32p, _i32p, _i32p, _i32p,
        _i32p, _i32p, np.ctypeslib.ndpointer(np.int32, shape=(2,)),
    ]
    lib.crt_thread_links.restype = None
    lib.crt_thread_links.argtypes = [
        _i32p, _i32p, _i32p, _i32p, ctypes.c_int, _i32p, ctypes.c_int, _i32p, _i32p,
    ]
    return NativeLibrary(lib, path, seconds)


def _stats(t0: float, host, max_depth: int) -> BuildStats:
    return BuildStats(
        build_time_us=int((time.perf_counter() - t0) * 1e6),
        max_depth=max_depth,
        num_nodes=int(host.nodes_used),
        num_leaves=int((host.tri_count > 0).sum()),
        max_leaf=int(host.tri_count.max()) if host.nodes_used else 0,
    )


def build_bvh_native(tri_v: np.ndarray, sah: bool = True, bins: int = 8,
                     force_split_cap: int | None = 4, leaf_target: int | None = None):
    """`crt_build_bvh`: the binned-SAH build of `bvh_builder.build_bvh`
    (`sah=False`: the midpoint split of the longest axis).  Returns
    (HostBVH, tri_indices [N] int32, BuildStats)."""
    lib = load().lib
    t0 = time.perf_counter()
    n = tri_v.shape[0]
    h = HostBVH(n)
    idx = np.zeros(max(n, 1), np.int32)
    max_depth = np.zeros(1, np.int32)
    h.nodes_used = lib.crt_build_bvh(
        np.ascontiguousarray(tri_v.reshape(n, 9), np.float32), n, int(sah), bins,
        0 if force_split_cap is None else force_split_cap,
        0 if leaf_target is None else leaf_target,
        h.node_min, h.node_max, h.left_first, h.tri_count, h.left, h.right, h.axis, idx,
        max_depth)
    h.trim()
    return h, idx[:n], _stats(t0, h, int(max_depth[0]))


def build_sbvh_native(tri_v: np.ndarray, bins: int = 8, leaf_target: int = 8,
                      alpha: float = 1e-5, ref_factor: float = 2.0):
    """`crt_build_sbvh`: the SBVH (spatial-split) build.  Returns the
    triple of `build_bvh_native`, where tri_indices is the leaves'
    reference list, of length >= N (a triangle straddling a spatial split
    is referenced by both children, with clipped boxes), or None where
    the node or reference cap (`ref_factor` N + 64 references) trips."""
    lib = load().lib
    t0 = time.perf_counter()
    n = tri_v.shape[0]
    ref_cap = max(int(n * ref_factor) + 64, 128)
    node_cap = max(4 * ref_cap, 64)
    h = HostBVH(n, cap=node_cap)
    idx = np.zeros(ref_cap, np.int32)
    meta = np.zeros(2, np.int32)
    used = lib.crt_build_sbvh(
        np.ascontiguousarray(tri_v.reshape(n, 9), np.float32), n, bins, leaf_target,
        ctypes.c_float(alpha), node_cap, ref_cap,
        h.node_min, h.node_max, h.left_first, h.tri_count, h.left, h.right, h.axis, idx, meta)
    if used < 0:
        return None
    h.nodes_used = used
    h.trim()
    return h, idx[: int(meta[1])], _stats(t0, h, int(meta[0]))


def thread_links_native(left, right, tri_count, axis, roots=None):
    """`crt_thread_links`: the per-octant hit and miss links of
    `bvh_builder.thread_links` (which checks the tree first), int32
    (hit [8, M], miss [8, M])."""
    lib = load().lib
    m = left.shape[0]
    roots_arr = np.asarray([0] if roots is None else roots, np.int32)
    hit = np.full((8, m), -1, np.int32)
    miss = np.full((8, m), -1, np.int32)
    lib.crt_thread_links(
        np.ascontiguousarray(left, np.int32), np.ascontiguousarray(right, np.int32),
        np.ascontiguousarray(tri_count, np.int32), np.ascontiguousarray(axis, np.int32),
        m, roots_arr, len(roots_arr), hit, miss)
    return hit, miss
