"""Flat tables of the reference walks (`ops/traverse_bvh.py`,
`ops/traverse_grid.py`, `ops/traverse_kd.py`, `ops/forest.py`), as the
JAX package's `cpu_ray_tracer_tpu/accel/types.py`: the triangle pool, the
threaded BVH, the uniform grid and the KD tree.  Each is a small
`nn.Module` whose arrays are registered buffers, so that `.to(device)`
moves it; the static fields (`max_leaf`, `max_depth`, `root`,
`resolution`, `max_cell_len`) are plain attributes.

The BVH is threaded (skip links): for each of the 8 ray-direction octants
every node stores the node to visit next when its box is hit (`hit_link`,
its near child for an interior node) and when it is missed or done
(`miss_link`), so a ray walks it with one cursor and no stack
(`bvh_builder.thread_links`).  The layouts join what one walk step reads
into one row, so that a step gathers each table once: `TrianglePool.rows`,
`BVHArrays.box`, `.leaf` and `.links`, `GridArrays.cell_range`,
`KDTreeArrays.node`.

The builders' outputs come first: `BuildStats`, a build's statistics, and
`HostBVH`, the numpy tables that both BVH builders (`accel/bvh_builder.py`
and its native twin `accel/native.py`) fill.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass
class BuildStats:
    """Host-side build instrumentation, as the reference's buildTime us and
    maxDepth (infra/bvh.cpp:6,22-23,111; the JAX package's
    accel/types.py:110-118)."""

    build_time_us: int = 0
    max_depth: int = 0
    num_nodes: int = 0
    num_leaves: int = 0
    max_leaf: int = 0


class HostBVH:
    """Builder output: per-node arrays, trimmed to `nodes_used`.  Interior
    nodes have `tri_count == 0` and children `left`/`right`; leaves hold
    `tri_count` triangles from `left_first` in the triangle index array.
    Room for `cap` nodes (default 2 n_tris - 1, a binary build's most)."""

    def __init__(self, n_tris: int, cap: int | None = None):
        cap = max(2 * n_tris - 1, 1) if cap is None else cap
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


def _buffers(module: nn.Module, **arrays) -> None:
    for name, x in arrays.items():
        x = np.ascontiguousarray(x)
        module.register_buffer(name, torch.from_numpy(
            x.astype(np.float32 if x.dtype.kind == "f" else np.int32)))


class TrianglePool(nn.Module):
    """The triangles the walks test and the hit ids they report, by pool
    id (the JAX package's `TrianglePool`: the fields the walks and
    `interpolate_hit` read).

    * `rows` float32 [N, 27]: v0, e1 = v1 - v0, e2 = v2 - v0, then each of
      the three rolled by one and by two lanes (`ops/intersect.roll3`);
    * `obj_id`, `mat_id` int32 [N];
    * `shade` float32 [N, 16]: the shading record n0 n1 n2 uv0 uv1 uv2
      (`accel/compile.shading_records`)."""

    def __init__(self, v0, e1, e2, obj_id, mat_id, shade):
        super().__init__()
        vs = [np.asarray(x, np.float32) for x in (v0, e1, e2)]
        rows = np.concatenate(vs + [x[:, r] for x in vs for r in ([1, 2, 0], [2, 0, 1])], axis=1)
        _buffers(self, rows=rows, obj_id=obj_id, mat_id=mat_id, shade=shade)


class BVHArrays(nn.Module):
    """Threaded flat BVH (the JAX package's `BVHArrays`): `tri_count == 0`
    marks an interior node; a leaf's triangles are `tri_indices[
    left_first : left_first + tri_count]`.  Buffers:

    * `box` float32 [M, 6]: node_min, node_max;
    * `leaf` int32 [M, 2]: left_first, tri_count;
    * `links` int32 [8 M, 2]: (hit_link, miss_link) of octant o and node n
      at row o M + n, -1 ending the walk;
    * `tri_indices` int32 [K]: pool ids in leaf order.

    `max_leaf` bounds a leaf's triangles (the walk's unroll), `max_depth`
    is the build's, `root` the node a walk starts at."""

    def __init__(self, node_min, node_max, left_first, tri_count, hit_link, miss_link,
                 tri_indices, max_leaf: int = 2, max_depth: int = 0, root: int = 0):
        super().__init__()
        _buffers(self, box=np.concatenate([node_min, node_max], axis=1).astype(np.float32),
                 leaf=np.stack([left_first, tri_count], axis=1),
                 links=np.stack([np.asarray(hit_link).reshape(-1),
                                 np.asarray(miss_link).reshape(-1)], axis=1),
                 tri_indices=tri_indices)
        self.max_leaf, self.max_depth, self.root = int(max_leaf), int(max_depth), int(root)

    @property
    def num_nodes(self) -> int:
        return self.box.shape[0]

    @property
    def device(self) -> torch.device:
        return self.box.device


class GridArrays(nn.Module):
    """Uniform grid with CSR cell lists (the JAX package's `GridArrays`,
    infra/grid.cpp:4-54 semantics).  Buffers `bounds_min`, `bounds_max`
    float32 [3]; `cell_start` int32 [C + 1] (the CSR offsets) and
    `cell_range` int32 [C, 2] (each cell's start and end, joined from it);
    `cell_tris` int32 [K] (pool ids, a triangle in every cell its box
    overlaps).  `resolution` (rx, ry, rz), `max_cell_len` the longest
    cell list."""

    def __init__(self, bounds_min, bounds_max, resolution, cell_start, cell_tris,
                 max_cell_len: int = 0):
        super().__init__()
        cs = np.asarray(cell_start)
        _buffers(self, bounds_min=bounds_min, bounds_max=bounds_max, cell_start=cs,
                 cell_range=np.stack([cs[:-1], cs[1:]], axis=1), cell_tris=cell_tris)
        self.resolution = tuple(int(x) for x in resolution)
        self.max_cell_len = int(max_cell_len)


class KDTreeArrays(nn.Module):
    """Flat KD tree (the JAX package's `KDTreeArrays`; midpoint split,
    straddlers duplicated: infra/kdtree.cpp:45-108).  Buffers:

    * `node` int32 [M, 5]: split_axis (-1 on a leaf), left, right, first,
      count; a leaf's triangles are `tri_ids[first : first + count]`;
    * `split_dist` float32 [M];
    * `tri_ids` int32 [K];
    * `bounds_min`, `bounds_max` float32 [3]: the root's box.

    `max_depth` is the build's depth cap (the walk's stack holds
    `max_depth + 2` entries), `max_leaf` the largest leaf."""

    def __init__(self, split_axis, split_dist, left, right, first, count, tri_ids, bounds_min,
                 bounds_max, max_depth: int = 20, max_leaf: int = 2):
        super().__init__()
        _buffers(self, node=np.stack([split_axis, left, right, first, count], axis=1),
                 split_dist=split_dist, tri_ids=tri_ids, bounds_min=bounds_min,
                 bounds_max=bounds_max)
        self.max_depth, self.max_leaf = int(max_depth), int(max_leaf)

    @property
    def num_nodes(self) -> int:
        return self.node.shape[0]
