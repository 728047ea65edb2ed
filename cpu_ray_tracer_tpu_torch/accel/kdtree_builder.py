"""KD-tree builder (host numpy), flat arrays + CSR leaf lists: the host side
of the JAX package's `cpu_ray_tracer_tpu/accel/kdtree_builder.py`
(`build_kdtree`, `_sah_split`).

Semantics of infra/kdtree.cpp:45-108: midpoint split on the node's longest
axis, max build depth 20, leaf at <= 2 triangles; triangles straddling the
split plane are DUPLICATED into both children.  `sah=True` takes the
binned-SAH split instead (the reference's KD_SAH, off by default,
blas_kdtree.h:3).  The kernels walk KD trees as cell forests
(`accel/cell_tree.py`); `to_device` gives the arrays of the reference KD
descent (`ops/traverse_kd.py`).
"""

from __future__ import annotations

import time

import numpy as np

from cpu_ray_tracer_tpu_torch.accel.bvh_builder import BuildStats
from cpu_ray_tracer_tpu_torch.accel.types import KDTreeArrays


def build_kdtree(
    tri_v: np.ndarray, max_build_depth: int = 20, leaf_size: int = 2, sah: bool = False,
    bins: int = 8,
) -> tuple[dict, BuildStats]:
    """tri_v [N, 3, 3] -> (dict(split_axis (-1 on leaves), split_dist,
    left, right, first, count, tri_ids, bounds_min, bounds_max, max_depth,
    max_leaf), BuildStats); node 0 is the root, children are numbered after
    parents."""
    t0 = time.perf_counter()
    n = tri_v.shape[0]
    tmin = tri_v.min(axis=1)
    tmax = tri_v.max(axis=1)
    root_min = tmin.min(axis=0) if n else np.zeros(3, np.float32)
    root_max = tmax.max(axis=0) if n else np.ones(3, np.float32)

    split_axis, split_dist, left, right, first, count = [], [], [], [], [], []
    tri_ids: list[np.ndarray] = []
    cursor = [0]  # triangle ids stored so far

    def new_node():
        split_axis.append(-1)
        split_dist.append(0.0)
        left.append(-1)
        right.append(-1)
        first.append(0)
        count.append(0)
        return len(split_axis) - 1

    def make_leaf(node, ids):
        split_axis[node] = -1
        first[node] = cursor[0]
        count[node] = len(ids)
        tri_ids.append(ids)
        cursor[0] += len(ids)

    stack = [(new_node(), np.arange(n, dtype=np.int32), root_min.copy(), root_max.copy(), 0)]
    max_depth_seen = 0
    while stack:
        node, ids, bmin, bmax, depth = stack.pop()
        max_depth_seen = max(max_depth_seen, depth)
        if len(ids) <= leaf_size or depth >= max_build_depth:
            make_leaf(node, ids)
            continue
        ext = bmax - bmin
        axis = -1
        if sah:
            axis, dist = _sah_split(tmin[ids], tmax[ids], bmin, bmax, bins)
        if axis < 0:
            axis = int(np.argmax(ext))
            dist = float(bmin[axis] + ext[axis] * 0.5)
        lids = ids[tmin[ids, axis] < dist]
        rids = ids[tmax[ids, axis] >= dist]
        if len(lids) == len(ids) and len(rids) == len(ids):
            # every triangle straddles: no progress possible -> leaf
            make_leaf(node, ids)
            continue
        li, ri = new_node(), new_node()
        split_axis[node] = axis
        split_dist[node] = dist
        left[node] = li
        right[node] = ri
        lmax = bmax.copy()
        lmax[axis] = dist
        rmin = bmin.copy()
        rmin[axis] = dist
        stack.append((ri, rids, rmin, bmax.copy(), depth + 1))
        stack.append((li, lids, bmin.copy(), lmax, depth + 1))

    counts = np.asarray(count, np.int32)
    leaf_counts = counts[np.asarray(split_axis) == -1]
    stats = BuildStats(
        build_time_us=int((time.perf_counter() - t0) * 1e6),
        max_depth=max_depth_seen,
        num_nodes=len(split_axis),
        num_leaves=int(leaf_counts.size),
        max_leaf=int(leaf_counts.max()) if leaf_counts.size else 0,
    )
    return dict(
        split_axis=np.asarray(split_axis, np.int32),
        split_dist=np.asarray(split_dist, np.float32),
        left=np.asarray(left, np.int32),
        right=np.asarray(right, np.int32),
        first=np.asarray(first, np.int32),
        count=counts,
        tri_ids=(np.concatenate(tri_ids) if tri_ids else np.zeros(0, np.int32)).astype(np.int32),
        bounds_min=root_min.astype(np.float32),
        bounds_max=root_max.astype(np.float32),
        max_depth=max_build_depth,
        max_leaf=stats.max_leaf,
    ), stats


def _sah_split(tmin, tmax, bmin, bmax, bins):
    """Binned SAH over candidate planes (blas_kdtree.cpp:122-225 spirit):
    cost = lcount*larea + rcount*rarea with straddle duplication counted on
    both sides.  Returns (axis, dist) or (-1, 0)."""
    best = (np.inf, -1, 0.0)
    ext = bmax - bmin
    for a in range(3):
        if ext[a] <= 0:
            continue
        for i in range(1, bins):
            dist = bmin[a] + ext[a] * (i / bins)
            lc = int((tmin[:, a] < dist).sum())
            rc = int((tmax[:, a] >= dist).sum())
            le = ext.copy()
            le[a] = dist - bmin[a]
            re = ext.copy()
            re[a] = bmax[a] - dist
            larea = le[0] * le[1] + le[1] * le[2] + le[2] * le[0]
            rarea = re[0] * re[1] + re[1] * re[2] + re[2] * re[0]
            cost = lc * larea + rc * rarea
            if cost < best[0]:
                best = (cost, a, float(dist))
    no_split = len(tmin) * (ext[0] * ext[1] + ext[1] * ext[2] + ext[2] * ext[0])
    if best[1] < 0 or best[0] >= no_split:
        return -1, 0.0
    return best[1], best[2]


def to_device(host: dict, device) -> KDTreeArrays:
    """The `KDTreeArrays` of a `build_kdtree` dict, on `device`."""
    return KDTreeArrays(*(host[k] for k in ("split_axis", "split_dist", "left", "right", "first",
                                            "count", "tri_ids", "bounds_min", "bounds_max")),
                        max_depth=host["max_depth"], max_leaf=host["max_leaf"]).to(device)
