"""Host build outputs (numpy) to the reference walks' tables on a device,
as the JAX package's `cpu_ray_tracer_tpu/accel/compile.py`:
`make_triangle_pool` and `bvh_arrays`, which threads a built tree
(`tree_tables`) or fused forest, the threading part of its `compile_bvh`
(the scene compiler builds each tree with the options it was given).
Every function takes the device explicitly."""

from __future__ import annotations

import numpy as np

from cpu_ray_tracer_tpu_torch.accel import bvh_builder
from cpu_ray_tracer_tpu_torch.accel.types import BuildStats, BVHArrays, HostBVH, TrianglePool


def shading_records(tri_v: np.ndarray, tri_n: np.ndarray, tri_uv: np.ndarray) -> np.ndarray:
    """float32 [N, 16]: n0 n1 n2 uv0 uv1 uv2 per triangle, lane 15 zero,
    with vertex normals of length under 1e-8 replaced by the geometric
    normal (the JAX package's `make_triangle_pool`)."""
    v0 = tri_v[:, 0]
    gn = np.cross(tri_v[:, 1] - v0, tri_v[:, 2] - v0)
    gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
    bad = np.linalg.norm(tri_n, axis=-1) < 1e-8
    tri_n = np.where(bad[..., None], gn[:, None, :], tri_n)
    shade16 = np.zeros((tri_v.shape[0], 16), np.float32)
    shade16[:, 0:9] = tri_n.reshape(-1, 9)
    shade16[:, 9:15] = tri_uv.reshape(-1, 6)
    return shade16


def make_triangle_pool(tri_v: np.ndarray, tri_n=None, tri_uv=None, obj_id=None, mat_id=None,
                       *, device) -> TrianglePool:
    """The `TrianglePool` of triangles tri_v [N, 3, 3] with vertex normals
    tri_n [N, 3, 3] (missing or zero-length ones: the geometric normal)
    and uvs [N, 3, 2] (default 0), object ids (default 2) and material ids
    (default 0), on `device`.  Lane 15 of the shading record holds the
    object id, as the JAX package's."""
    n = tri_v.shape[0]
    tri_n = np.zeros((n, 3, 3), np.float32) if tri_n is None else tri_n
    tri_uv = np.zeros((n, 3, 2), np.float32) if tri_uv is None else tri_uv
    obj_id = np.full(n, 2, np.int32) if obj_id is None else obj_id
    mat_id = np.zeros(n, np.int32) if mat_id is None else mat_id
    shade = shading_records(tri_v, tri_n, tri_uv)
    shade[:, 15] = obj_id
    v0 = tri_v[:, 0]
    return TrianglePool(v0, tri_v[:, 1] - v0, tri_v[:, 2] - v0, obj_id, mat_id,
                        shade).to(device)


def tree_tables(h: HostBVH, tri_indices: np.ndarray) -> dict:
    """The arrays of one built tree `h` (root 0) with its leaf-partitioned
    triangle order `tri_indices`, as `bvh_arrays` and `pack.pack_bvh`
    take them."""
    return dict(node_min=h.node_min, node_max=h.node_max, left=h.left, right=h.right,
                axis=h.axis, left_first=h.left_first, tri_count=h.tri_count,
                tri_indices=tri_indices, root=0)


def bvh_arrays(host: dict, stats: BuildStats, device) -> BVHArrays:
    """The `BVHArrays` of a built tree or fused forest `host` (`node_min`,
    `node_max`, `left`, `right`, `axis`, `left_first`, `tri_count`,
    `tri_indices`, `root`), threaded from its root by
    `bvh_builder.thread_links`, with the leaf size and depth of `stats`,
    on `device`."""
    hit, miss = bvh_builder.thread_links(host["left"], host["right"], host["tri_count"],
                                         host["axis"], roots=[host["root"]])
    return BVHArrays(host["node_min"], host["node_max"], host["left_first"], host["tri_count"],
                     hit, miss, host["tri_indices"], max_leaf=stats.max_leaf,
                     max_depth=stats.max_depth, root=host["root"]).to(device)
