"""Host-side binned-SAH BVH builder, as the JAX package's
`cpu_ray_tracer_tpu/accel/bvh_builder.py` (`build_bvh`, `thread_links`,
`refit_bvh`), with its two builders:

* `builder="native"` (the default, as the JAX package's, whose loader
  takes the C++ library wherever it loads): the C++ build of
  `accel/native.py`, the port's copy of the JAX package's
  native/crt_native.cpp, compiled with the same flags, so that both
  packages build the same trees; `sbvh=True` takes its SBVH build
  (spatial splits, the JAX package's `CRT_SBVH=1`);
* `builder="numpy"`: the numpy path of the JAX package's `build_bvh`,
  line for line (the JAX package's `CRT_NATIVE=0`).

The two compare the SAH costs in float32 (C++) and float64 (numpy), so
their trees may differ where two split costs nearly tie; node numbering,
split choices and the leaf-partitioned triangle order match the JAX
package's builder of the same kind.  Build semantics follow the
reference (infra/bvh.cpp:63-178):

* node bounds grown from triangle vertices (UpdateNodeBounds);
* centroid = (v0 + v1 + v2) * 0.3333 — the reference's inexact third
  (infra/model.cpp:78) is kept on purpose;
* split plane from an 8-bin SAH sweep over the centroid extent per axis
  (FindBestSplitPlane), cost = triCount * half-area;
* recursion stops at <= `leaf_target` triangles (None: the reference's
  2) or when the best split does not beat the parent cost
  (CalculateNodeCost);
* in-place partition of the triangle index array by centroid < splitPos.

`force_split_cap`: a no-gain SAH stop with more than this many triangles
falls back to a median split, bounding the leaf size (None: the
reference's stop exactly).  The defaults `FORCE_SPLIT_CAP` and
`LEAF_TARGET` are the values the JAX package's compiler sets for its packed
kernel tables (scene/build.py:107-111 there); its parity mode sets both to
None.  The build returns its `BuildStats` (the JAX package's
accel/types.py:110-118).

`thread_links` threads a tree or forest with per-octant hit and miss
links for the link walk (`ops/link_walk.py`), by the C++ walk whichever
builder built the tree (the links depend on the topology alone);
`refit_bvh` grows a built tree's bounds to moved triangles, its
topology kept (numpy only, as in the JAX package).
"""

from __future__ import annotations

import time

import numpy as np

from cpu_ray_tracer_tpu_torch.accel import native
from cpu_ray_tracer_tpu_torch.accel.types import BuildStats, HostBVH

BUILDERS = ("native", "numpy")

BINS = 8
FORCE_SPLIT_CAP = 4
LEAF_TARGET = 24


def tri_centroids(tri_v: np.ndarray) -> np.ndarray:
    """[N, 3, 3] vertices -> [N, 3] centroids, reference-scaled by 0.3333."""
    return tri_v.sum(axis=1) * np.float32(0.3333)


def _half_area(bmin: np.ndarray, bmax: np.ndarray) -> float:
    e = np.maximum(bmax - bmin, 0.0)
    return float(e[0] * e[1] + e[1] * e[2] + e[2] * e[0])


def check_builder(builder: str, sbvh: bool = False) -> None:
    """Raise for an unknown builder, or an SBVH asked of the numpy one."""
    if builder not in BUILDERS:
        raise ValueError(f"builder={builder!r}: expected 'native' or 'numpy'")
    if sbvh and builder != "native":
        raise ValueError("sbvh=True needs builder='native': there is no numpy SBVH build")


def build_bvh(tri_v: np.ndarray, force_split_cap: int | None = FORCE_SPLIT_CAP,
              leaf_target: int | None = LEAF_TARGET, builder: str = "native",
              sbvh: bool = False):
    """Build a binned-SAH BVH over triangles `tri_v` [N, 3, 3] with
    `builder` (module docstring).

    `sbvh=True` builds the SBVH (native only) with leaves of `leaf_target`,
    8 where it is None, and no `force_split_cap` (its own median fallback
    splits nodes over four leaves' worth), as the JAX package's
    `CRT_SBVH=1` (bvh_builder.py:89-100 there); where its node or
    reference cap trips it builds the plain SAH tree, as the JAX package
    does.  Its tri_indices may repeat a triangle (`accel/native.py`).

    Returns (HostBVH, tri_indices [N] int32 (SBVH: [K >= N]), BuildStats)."""
    check_builder(builder, sbvh)
    if sbvh:
        built = native.build_sbvh_native(tri_v, bins=BINS, leaf_target=leaf_target or 8)
        if built is not None:
            return built
    if builder == "native":
        return native.build_bvh_native(tri_v, bins=BINS, force_split_cap=force_split_cap,
                                       leaf_target=leaf_target)
    leaf_stop = 2 if leaf_target is None else leaf_target
    t0 = time.perf_counter()
    n = tri_v.shape[0]
    cent = tri_centroids(tri_v)
    tmin = tri_v.min(axis=1)  # [N, 3] per-tri AABB (vertex min)
    tmax = tri_v.max(axis=1)

    idx = np.arange(n, dtype=np.int32)
    bvh = HostBVH(n)
    root = 0
    bvh.left_first[root] = 0
    bvh.tri_count[root] = n

    stack = [(root, 0)]
    max_depth = 0
    while stack:
        node, depth = stack.pop()
        first = int(bvh.left_first[node])
        count = int(bvh.tri_count[node])
        sl = idx[first : first + count]
        # UpdateNodeBounds: grow from vertices
        bvh.node_min[node] = tmin[sl].min(axis=0)
        bvh.node_max[node] = tmax[sl].max(axis=0)
        max_depth = max(max_depth, depth)
        if count <= leaf_stop:
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
            if force_split_cap is not None and count > force_split_cap:
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
                if force_split_cap is not None and count > force_split_cap:
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
        stack.append((ri, depth + 1))
        stack.append((li, depth + 1))

    bvh.trim()
    stats = BuildStats(
        build_time_us=int((time.perf_counter() - t0) * 1e6),
        max_depth=max_depth,
        num_nodes=int(bvh.nodes_used),
        num_leaves=int((bvh.tri_count > 0).sum()),
        max_leaf=int(bvh.tri_count.max()),
    )
    return bvh, idx, stats


def refit_bvh(host: HostBVH, tri_indices: np.ndarray, tri_v: np.ndarray) -> None:
    """Bottom-up bounds refit after vertex motion, the topology unchanged
    (BVH::Refit, infra/bvh.cpp:26-43), in place on `host`, as the JAX
    package's `refit_bvh` (accel/bvh_builder.py:225-264 there): the leaves
    by one segmented min/max over the leaf-partitioned triangle order, the
    interior nodes in at most tree-height sweeps (children carry larger
    indices than their parent).  Threaded links stay valid: they encode
    topology, not bounds."""
    m = host.nodes_used
    if m == 0:
        return
    tmin = tri_v.min(axis=1)
    tmax = tri_v.max(axis=1)
    leaf = host.tri_count[:m] > 0
    leaf_ids = np.nonzero(leaf)[0]
    leaf_ids = leaf_ids[np.argsort(host.left_first[leaf_ids], kind="stable")]
    starts = host.left_first[leaf_ids]
    host.node_min[leaf_ids] = np.minimum.reduceat(tmin[tri_indices], starts, axis=0)
    host.node_max[leaf_ids] = np.maximum.reduceat(tmax[tri_indices], starts, axis=0)
    li, ri = host.left[:m], host.right[:m]
    done = leaf.copy()
    while not done.all():
        ids = np.nonzero(~done & done[li] & done[ri])[0]
        if ids.size == 0:
            raise RuntimeError("refit_bvh: malformed topology (no node is ready)")
        host.node_min[ids] = np.minimum(host.node_min[li[ids]], host.node_min[ri[ids]])
        host.node_max[ids] = np.maximum(host.node_max[li[ids]], host.node_max[ri[ids]])
        done[ids] = True


def thread_links(left, right, tri_count, axis, roots=None) -> tuple[np.ndarray, np.ndarray]:
    """Per-octant hit and miss links of a threaded tree or forest, as the
    JAX package's `thread_links` with its library loaded (the C++ walk of
    `accel/native.py`; its numpy twin there gives the same links): int32
    (hit [8, M], miss [8, M]).  For octant `o` (bit a set: the direction is
    negative along axis a) the depth-first order visits each interior
    node's near child first, the left (lower) child when the direction is
    not negative along the node's split axis (infra/bvh.cpp:245-249).  A
    forest's trees are chained in `roots` order: finishing one continues
    at the next root.

    A node with no children and no triangles is refused: the JAX package
    would thread it as an interior node whose hit link is -1 and end the
    walk there.  So is an interior node with a child or a root outside
    the tree, which the C++ walk would write past its tables."""
    m = left.shape[0]
    roots = [0] if roots is None else [int(r) for r in roots]
    is_leaf = tri_count > 0
    empty = np.nonzero((left < 0) & ~is_leaf)[0]
    if empty.size:
        raise ValueError(f"node {int(empty[0])} has neither children nor triangles")
    inner = ~is_leaf
    stray = np.nonzero(inner & ((left >= m) | (right < 0) | (right >= m)))[0]
    if stray.size or any(not 0 <= r < m for r in roots):
        raise ValueError(f"a child or a root outside the tree of {m} nodes")
    return native.thread_links_native(left, right, tri_count, axis, roots=roots)
