"""Packing a BVH and its triangles into the tables the closest-hit kernel
reads (`csrc/closest_hit.cu`, `ops/closest_hit.py`).

The JAX package packs nodes 8 per 128-lane row and triangles 8 per row with
degenerate padding (`cpu_ray_tracer_tpu/accel/pack.py:90-240`): a layout
for the TPU's (8, 128) vector tiles.  One thread per ray on Hopper wants
the opposite — one record per node, contiguous, so that a thread reads the
fields it needs from one or two 32-byte sectors:

* `nodes` int32 [M, 24] (96 bytes per node; float fields bit-cast):
  words 0-2 bmin xyz, 3-5 bmax xyz, 6 the leaf's first triangle slot,
  7 its triangle count (0 = interior node), 8 + 2*o and 9 + 2*o the near
  and far child for ray-direction octant o (-1 on leaves);
* `tris` float32 [S, 9]: v0, e1 = v1 - v0, e2 = v2 - v0 per slot, the
  slots leaf after leaf in node order, unpadded;
* `shade` float32 [S, 16]: n0 n1 n2 uv0 uv1 uv2, and in lane 15 the meta
  word `tri | obj << 20 | mat << 26` bit-cast, as the JAX package's
  `pack_host` stores it;
* for a tree walked by hit/miss links (the grid and KD cell forests,
  `accel/cell_tree.py`), `links` int32 [M, 16]: words 2*o and 2*o + 1 the
  hit and miss link for ray-direction octant o (64 bytes per node; the
  JAX package's `node_links` [8, 2, M]), and the forest's root list.

Node numbering and the triangle order inside each leaf are the JAX
package's, so the two packages' tables compare one to one.  Every
accelerator uses the same `tris` / `shade` slot layout, so hit ids decode
the same way whichever walk found the slot.
"""

from __future__ import annotations

import dataclasses

import numpy as np

NODE_WORDS = 24
N_BMIN = 0
N_BMAX = 3
N_FIRST = 6
N_COUNT = 7
N_NEARFAR = 8
# per-thread stack capacity of the closest-hit walk (`csrc/closest_hit.cu`
# STACK_CAP); the walk pushes at most one far child per level of the tree
STACK_CAP = 64


@dataclasses.dataclass
class PackedBVH:
    nodes: np.ndarray  # int32 [M, NODE_WORDS]
    tris: np.ndarray  # float32 [S, 9]
    shade: np.ndarray  # float32 [S, 16], meta word bit-cast in lane 15
    root: int
    depth: int  # depth of the deepest tree, root level = 1
    links: np.ndarray | None  # int32 [M, 16] per-octant (hit, miss) links, or None
    roots: tuple  # the roots in walk order (one, unless a forest)


def nearfar_from_children(left: np.ndarray, right: np.ndarray, axis: np.ndarray) -> np.ndarray:
    """Per-octant (near, far) child table, as the JAX package's
    `nearfar_from_children`: the near child on split axis `a` is the LEFT
    (lower-coordinate) child when the ray direction's component a is not
    negative (infra/bvh.cpp:224-258 made octant-static).  Returns int32
    [8, 2, M]; leaves carry -1."""
    m = left.shape[0]
    out = np.full((8, 2, m), -1, np.int32)
    interior = left >= 0
    for o in range(8):
        neg = ((o >> axis) & 1) > 0
        out[o, 0] = np.where(interior, np.where(neg, right, left), -1)
        out[o, 1] = np.where(interior, np.where(neg, left, right), -1)
    return out


def tree_depth(left: np.ndarray, right: np.ndarray, root: int) -> int:
    """Depth of the tree rooted at `root` (root level = 1), level-order."""
    depth = 0
    frontier = np.array([root], np.int64)
    while frontier.size:
        depth += 1
        kids = np.concatenate([left[frontier], right[frontier]])
        frontier = kids[kids >= 0]
    return depth


def meta_words(obj_id: np.ndarray, mat_id: np.ndarray) -> np.ndarray:
    """Per-triangle `tri | obj << 20 | mat << 26` (int32).  mat rides bits
    26-30 so that the sign bit stays clear: 20 / 6 / 5 bits."""
    n = obj_id.shape[0]
    if n >= (1 << 20) or obj_id.max(initial=0) >= (1 << 6) or mat_id.max(initial=0) >= (1 << 5):
        raise ValueError("triangle, object or material id too wide for the meta word")
    return (
        np.arange(n, dtype=np.int32)
        | (obj_id.astype(np.int32) << 20)
        | (mat_id.astype(np.int32) << 26)
    )


def make_tables(
    node_min, node_max, first, count, nearfar, tris, shade, root: int, depth: int,
    links=None, roots=None,
) -> PackedBVH:
    """Assemble the node records.  `nearfar` int32 [8, 2, M]; `links`
    (hit, miss) int32 [8, M] each, for a tree walked by links, which needs
    no stack (so its depth is not bounded by STACK_CAP)."""
    m = node_min.shape[0]
    if links is None and depth > STACK_CAP:
        raise ValueError(f"tree depth {depth} exceeds the walk's stack capacity {STACK_CAP}")
    if links is not None:
        links = np.stack(links, axis=2).astype(np.int32).transpose(1, 0, 2).reshape(m, 16)
    nodes = np.zeros((m, NODE_WORDS), np.int32)
    nodes[:, N_BMIN : N_BMIN + 3] = np.asarray(node_min, np.float32).view(np.int32)
    nodes[:, N_BMAX : N_BMAX + 3] = np.asarray(node_max, np.float32).view(np.int32)
    nodes[:, N_FIRST] = first
    nodes[:, N_COUNT] = count
    nodes[:, N_NEARFAR:] = np.transpose(nearfar, (2, 0, 1)).reshape(m, 16)
    return PackedBVH(
        nodes=nodes,
        tris=np.ascontiguousarray(tris, np.float32),
        shade=np.ascontiguousarray(shade, np.float32),
        root=int(root),
        depth=int(depth),
        links=links,
        roots=tuple(int(r) for r in (roots or [root])),
    )


def pack_bvh(
    node_min, node_max, left, right, axis, left_first, tri_count, tri_indices,
    tri_v, shade16, obj_id, mat_id, root: int, links=None, roots=None,
) -> PackedBVH:
    """Pack a host BVH (or the fused TLAS forest) over triangles `tri_v`
    [N, 3, 3] with per-triangle shading records `shade16` [N, 16].  A cell
    forest passes its `links` (`bvh_builder.thread_links`) and `roots`."""
    leaf_ids = np.nonzero(tri_count > 0)[0]
    # slots: leaf after leaf in node order, each leaf's triangles in its
    # tri_indices order (the JAX package's `pack_tri_rows` order, unpadded)
    slot_tri = np.concatenate(
        [tri_indices[left_first[n] : left_first[n] + tri_count[n]] for n in leaf_ids]
    )
    first = np.zeros(node_min.shape[0], np.int32)
    first[leaf_ids] = np.concatenate([[0], np.cumsum(tri_count[leaf_ids])[:-1]])
    v0 = tri_v[:, 0]
    tris = np.concatenate([v0, tri_v[:, 1] - v0, tri_v[:, 2] - v0], axis=1)[slot_tri]
    shade = np.ascontiguousarray(shade16, np.float32).copy()
    shade.view(np.int32)[:, 15] = meta_words(obj_id, mat_id)
    roots = [root] if roots is None else list(roots)
    depth = max(tree_depth(left, right, r) for r in roots)
    return make_tables(
        node_min, node_max, first, tri_count, nearfar_from_children(left, right, axis),
        tris, shade[slot_tri], root, depth, links=links, roots=roots,
    )
