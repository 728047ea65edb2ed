"""Uniform-grid builder (host numpy), CSR cell lists: the host side of the
JAX package's `cpu_ray_tracer_tpu/accel/grid_builder.py` (`build_grid`).

Semantics of infra/grid.cpp:4-54: per-axis resolution =
floor(size_axis * (5*N/V)^(1/3)) clamped to [1, 128]; each triangle is
inserted into every cell its AABB overlaps.  The kernels walk grids as
cell forests (`accel/cell_tree.py`); `to_device` gives the arrays of the
reference DDA (`ops/traverse_grid.py`).
"""

from __future__ import annotations

import time

import numpy as np

from cpu_ray_tracer_tpu_torch.accel.bvh_builder import BuildStats
from cpu_ray_tracer_tpu_torch.accel.types import GridArrays


def build_grid(tri_v: np.ndarray, max_res: int = 128) -> tuple[dict, BuildStats]:
    """tri_v [N, 3, 3] -> (dict(bounds_min, bounds_max, resolution (rx, ry,
    rz), cell_start int32 [cells + 1], cell_tris int32, max_cell_len),
    BuildStats: cells as nodes, non-empty cells as leaves)."""
    t0 = time.perf_counter()
    n = tri_v.shape[0]
    tmin = tri_v.min(axis=1)
    tmax = tri_v.max(axis=1)
    bmin = tmin.min(axis=0)
    bmax = tmax.max(axis=0)
    size = bmax - bmin
    vol = float(size[0] * size[1] * size[2])
    cube_root = (5.0 * n / max(vol, 1e-20)) ** (1.0 / 3.0)
    res = np.clip(np.floor(size * cube_root).astype(np.int64), 1, max_res)
    rx, ry, rz = int(res[0]), int(res[1]), int(res[2])
    cell_size = size / res

    lo = np.clip(((tmin - bmin) / cell_size).astype(np.int64), 0, res - 1)
    hi = np.clip(((tmax - bmin) / cell_size).astype(np.int64), 0, res - 1)
    total = int((hi - lo + 1).prod(axis=1).sum())

    # expand (tri, cell) pairs
    cell_ids = np.empty(total, np.int64)
    tri_ids = np.empty(total, np.int32)
    pos = 0
    for i in range(n):
        cx, cy, cz = np.meshgrid(
            np.arange(lo[i, 0], hi[i, 0] + 1), np.arange(lo[i, 1], hi[i, 1] + 1),
            np.arange(lo[i, 2], hi[i, 2] + 1), indexing="ij",
        )
        ids = (cx + cy * rx + cz * rx * ry).reshape(-1)
        cell_ids[pos : pos + ids.shape[0]] = ids
        tri_ids[pos : pos + ids.shape[0]] = i
        pos += ids.shape[0]

    n_cells = rx * ry * rz
    order = np.argsort(cell_ids, kind="stable")
    cell_ids = cell_ids[order]
    tri_ids = tri_ids[order]
    cell_start = np.zeros(n_cells + 1, np.int64)
    np.add.at(cell_start, cell_ids + 1, 1)
    cell_start = np.cumsum(cell_start)
    lens = np.diff(cell_start)
    stats = BuildStats(
        build_time_us=int((time.perf_counter() - t0) * 1e6),
        max_depth=0,
        num_nodes=n_cells,
        num_leaves=int((lens > 0).sum()),
        max_leaf=int(lens.max()) if n_cells else 0,
    )
    return dict(
        bounds_min=bmin.astype(np.float32),
        bounds_max=bmax.astype(np.float32),
        resolution=(rx, ry, rz),
        cell_start=cell_start.astype(np.int32),
        cell_tris=tri_ids,
        max_cell_len=stats.max_leaf,
    ), stats


def to_device(host: dict, device) -> GridArrays:
    """The `GridArrays` of a `build_grid` dict, on `device`."""
    return GridArrays(host["bounds_min"], host["bounds_max"], host["resolution"],
                      host["cell_start"], host["cell_tris"], host["max_cell_len"]).to(device)
