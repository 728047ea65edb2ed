"""Host-side (numpy) binned-SAH BVH builder.

The numpy path of the JAX package's `cpu_ray_tracer_tpu/accel/bvh_builder.py`
(`build_bvh`), line for line, so that both packages build the same tree
from the same triangles: node numbering, split choices and the
leaf-partitioned triangle order all match.  Build semantics follow the
reference (infra/bvh.cpp:63-178):

* node bounds grown from triangle vertices (UpdateNodeBounds);
* centroid = (v0 + v1 + v2) * 0.3333 — the reference's inexact third
  (infra/model.cpp:78) is kept on purpose;
* split plane from an 8-bin SAH sweep over the centroid extent per axis
  (FindBestSplitPlane), cost = triCount * half-area;
* recursion stops at <= `LEAF_TARGET` triangles or when the best split
  does not beat the parent cost (CalculateNodeCost);
* in-place partition of the triangle index array by centroid < splitPos.

`FORCE_SPLIT_CAP`: a no-gain SAH stop with more than this many triangles
falls back to a median split, bounding the leaf size.  Both values are the
ones the JAX package's compiler sets for its packed kernel tables
(scene/build.py:107-111 there).

`thread_links` threads a tree or forest with per-octant hit and miss
links for the link walk (`ops/link_walk.py`).

The native C++ builder, the SBVH spatial-split build and the build
statistics of the JAX package are not ported yet (ROADMAP).
"""

from __future__ import annotations

import numpy as np

BINS = 8
FORCE_SPLIT_CAP = 4
LEAF_TARGET = 24


def tri_centroids(tri_v: np.ndarray) -> np.ndarray:
    """[N, 3, 3] vertices -> [N, 3] centroids, reference-scaled by 0.3333."""
    return tri_v.sum(axis=1) * np.float32(0.3333)


def _half_area(bmin: np.ndarray, bmax: np.ndarray) -> float:
    e = np.maximum(bmax - bmin, 0.0)
    return float(e[0] * e[1] + e[1] * e[2] + e[2] * e[0])


class HostBVH:
    """Builder output: per-node arrays, trimmed to `nodes_used`.  Interior
    nodes have `tri_count == 0` and children `left`/`right`; leaves hold
    `tri_count` triangles from `left_first` in the triangle index array."""

    def __init__(self, n_tris: int):
        cap = max(2 * n_tris - 1, 1)
        self.node_min = np.full((cap, 3), 1e30, np.float32)
        self.node_max = np.full((cap, 3), -1e30, np.float32)
        self.left_first = np.zeros(cap, np.int32)
        self.tri_count = np.zeros(cap, np.int32)
        self.left = np.full(cap, -1, np.int32)
        self.right = np.full(cap, -1, np.int32)
        self.axis = np.zeros(cap, np.int32)
        self.nodes_used = 1

    def trim(self):
        m = self.nodes_used
        for name in ("node_min", "node_max", "left_first", "tri_count", "left", "right", "axis"):
            setattr(self, name, getattr(self, name)[:m])
        return self


def build_bvh(tri_v: np.ndarray):
    """Build a binned-SAH BVH over triangles `tri_v` [N, 3, 3].

    Returns (HostBVH, tri_indices [N] int32)."""
    n = tri_v.shape[0]
    cent = tri_centroids(tri_v)
    tmin = tri_v.min(axis=1)  # [N, 3] per-tri AABB (vertex min)
    tmax = tri_v.max(axis=1)

    idx = np.arange(n, dtype=np.int32)
    bvh = HostBVH(n)
    root = 0
    bvh.left_first[root] = 0
    bvh.tri_count[root] = n

    stack = [root]
    while stack:
        node = stack.pop()
        first = int(bvh.left_first[node])
        count = int(bvh.tri_count[node])
        sl = idx[first : first + count]
        # UpdateNodeBounds: grow from vertices
        bvh.node_min[node] = tmin[sl].min(axis=0)
        bvh.node_max[node] = tmax[sl].max(axis=0)
        if count <= LEAF_TARGET:
            continue

        axis = -1
        split_pos = 0.0
        do_median = False
        best_cost = 1e30
        c = cent[sl]
        for a in range(3):
            cmin = float(c[:, a].min())
            cmax = float(c[:, a].max())
            if cmin == cmax:
                continue
            scale = BINS / (cmax - cmin)
            bidx = np.minimum((BINS - 1), ((c[:, a] - cmin) * scale).astype(np.int64))
            # per-bin counts and grown bounds (from tri vertices)
            counts = np.bincount(bidx, minlength=BINS)
            bin_min = np.full((BINS, 3), 1e30, np.float32)
            bin_max = np.full((BINS, 3), -1e30, np.float32)
            np.minimum.at(bin_min, bidx, tmin[sl])
            np.maximum.at(bin_max, bidx, tmax[sl])
            # prefix/suffix sweeps over the 7 planes
            lmin = np.minimum.accumulate(bin_min, axis=0)
            lmax = np.maximum.accumulate(bin_max, axis=0)
            rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
            lcount = np.cumsum(counts)
            rcount = np.cumsum(counts[::-1])[::-1]
            for i in range(BINS - 1):
                le = np.maximum(lmax[i] - lmin[i], 0.0)
                re = np.maximum(rmax[i + 1] - rmin[i + 1], 0.0)
                larea = le[0] * le[1] + le[1] * le[2] + le[2] * le[0] if lcount[i] else 0.0
                rarea = re[0] * re[1] + re[1] * re[2] + re[2] * re[0] if rcount[i + 1] else 0.0
                cost = lcount[i] * larea + rcount[i + 1] * rarea
                if cost < best_cost:
                    best_cost = cost
                    axis = a
                    split_pos = cmin + (cmax - cmin) / BINS * (i + 1)
        no_split_cost = count * _half_area(bvh.node_min[node], bvh.node_max[node])
        if axis < 0 or best_cost >= no_split_cost:
            if count > FORCE_SPLIT_CAP:
                do_median = True
            else:
                continue  # leaf (reference SAH no-gain stop)

        if do_median:
            ext = bvh.node_max[node] - bvh.node_min[node]
            axis = int(np.argmax(ext))
            order = np.argsort(cent[sl, axis], kind="stable")
            idx[first : first + count] = sl[order]
            left_count = count // 2
        else:
            mask = cent[sl, axis] < split_pos
            left_count = int(mask.sum())
            if left_count == 0 or left_count == count:
                if count > FORCE_SPLIT_CAP:
                    order = np.argsort(cent[sl, axis], kind="stable")
                    idx[first : first + count] = sl[order]
                    left_count = count // 2
                else:
                    continue  # leaf (degenerate partition)
            else:
                idx[first : first + count] = np.concatenate([sl[mask], sl[~mask]])

        li = bvh.nodes_used
        ri = bvh.nodes_used + 1
        bvh.nodes_used += 2
        bvh.left_first[li] = first
        bvh.tri_count[li] = left_count
        bvh.left_first[ri] = first + left_count
        bvh.tri_count[ri] = count - left_count
        bvh.left[node] = li
        bvh.right[node] = ri
        bvh.axis[node] = axis
        bvh.left_first[node] = li
        bvh.tri_count[node] = 0
        stack.append(ri)
        stack.append(li)

    return bvh.trim(), idx


def thread_links(left, right, tri_count, axis, roots=None) -> tuple[np.ndarray, np.ndarray]:
    """Per-octant hit and miss links of a threaded tree or forest, as the
    numpy path of the JAX package's `thread_links`: int32 (hit [8, M],
    miss [8, M]).  For octant `o` (bit a set: the direction is negative
    along axis a) the depth-first order visits each interior node's near
    child first, the left (lower) child when the direction is not negative
    along the node's split axis (infra/bvh.cpp:245-249).  A forest's trees
    are chained in `roots` order: finishing one continues at the next root.

    A node with no children and no triangles is refused: the JAX package
    would thread it as an interior node whose hit link is -1 and end the
    walk there."""
    m = left.shape[0]
    roots = [0] if roots is None else [int(r) for r in roots]
    is_leaf = tri_count > 0
    empty = np.nonzero((left < 0) & ~is_leaf)[0]
    if empty.size:
        raise ValueError(f"node {int(empty[0])} has neither children nor triangles")
    hit = np.full((8, m), -1, np.int32)
    miss = np.full((8, m), -1, np.int32)
    for o in range(8):
        neg = [(o >> a) & 1 for a in range(3)]
        ho, mo = hit[o], miss[o]
        # (node, exit link); root i exits into root i + 1
        stack = [(roots[i], roots[i + 1] if i + 1 < len(roots) else -1)
                 for i in range(len(roots) - 1, -1, -1)]
        while stack:
            node, ex = stack.pop()
            mo[node] = ex
            if is_leaf[node]:
                ho[node] = ex
                continue
            if neg[int(axis[node])]:
                near, far = int(right[node]), int(left[node])
            else:
                near, far = int(left[node]), int(right[node])
            ho[node] = near
            stack.append((near, far))
            stack.append((far, ex))
    return hit, miss
