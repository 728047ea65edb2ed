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
  `pack_host` stores it where the ids fit (`meta_in_shade`); where they do
  not (2^20 triangles or more, an object id past 63, a material id past
  31) lane 15 holds the material id as a float, as there, and
  `slot_ids` int32 [S, 4] holds each slot's (tri, obj, mat, 0): the JAX
  package's `slot_tri` joined with the per-triangle ids, one 16-byte load;
* for a tree walked by hit/miss links (the grid and KD cell forests,
  `accel/cell_tree.py`, and a BVH deeper than STACK_CAP), `links` int32
  [M, 16]: words 2*o and 2*o + 1 the hit and miss link for ray-direction
  octant o (64 bytes per node; the JAX package's `node_links` [8, 2, M]),
  and the forest's root list.

Those are the tables the plain versions read and the tests hold to the
JAX package's.  The CUDA walks read three tables built from them, laid out
so that one step of a walk is one dependent round trip to one record
(`csrc/ptraverse.cuh`):

* `node_records` int32 [M, 16] (64 bytes, four 16-byte loads), the binary
  stack walk's: row n of an interior node holds words 0-5 its left
  child's box, 6-11 its right child's box, 12 and 13 the left and right
  child's ref, 14 a swap mask whose bit o is set where the near child for
  octant o is the right one (read off `nodes`' near words), 15 unused.  A
  child ref is the child's node id for an interior child and `~code`
  (negative) for a leaf (below).  Leaf rows are zero, except that a one-leaf
  tree's root row holds its box in words 0-5 and its ref in word 12; the
  walks then start at `record_root` = ~root;
* `link_records` int32 [8, M, 8] (32 bytes, two 16-byte loads from one
  sector), the link walk's, octant-major: record (o, n) holds words 0-5
  node n's box, 6 its hit link for octant o where n is interior and
  `~code` (negative) where n is a leaf, whose hit link is its miss link,
  7 its miss link for octant o;
* `tris4` float32 [S, 12]: `tris` with v0, e1 and e2 each padded to four
  floats, three 16-byte loads per triangle; word 3 of a slot holds, bit
  cast, the number of slots from it to its leaf's end.

A leaf's code takes one of two forms, one for all the leaves of a table
(`leaf_codes`): where every leaf has fewer than 2^(31 - LEAF_SHIFT)
triangles and a first slot below 2^LEAF_SHIFT, `count << LEAF_SHIFT |
first`, so the count comes with the record, as the walks were first
built; otherwise the first slot alone, in a full int32 word, and the walk
reads the count with the leaf's triangles (`tris4` word 3).  Either way a
leaf's slots and count reach full int32 words, as the JAX package's
`node_meta2`, and a step stays one round trip to one record; the kernels
are compiled for both forms (`csrc/ptraverse.cuh`).

Node numbering and the triangle order inside each leaf are the JAX
package's, so the two packages' tables compare one to one.  Every
accelerator uses the same `tris` / `shade` slot layout, so hit ids decode
the same way whichever walk found the slot.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cpu_ray_tracer_tpu_torch.accel import bvh_builder

NODE_WORDS = 24
N_BMIN = 0
N_BMAX = 3
N_FIRST = 6
N_COUNT = 7
N_NEARFAR = 8
# per-thread stack capacity of the binary stack walk (`csrc/ptraverse.cuh`
# STACK_CAP), the JAX package's (packet_bvh.py:114).  The walk pushes at
# most one far child per level of the tree, so a tree of depth <= STACK_CAP
# never fills it; a deeper BVH is threaded with links and walked by them
# (make_tables), as the JAX package's gate sends it to its link walk
# (packet_bvh.py:830-843, wavefront_pt.py:563-568)
STACK_CAP = 128
# a leaf code's first-slot bits where the table's leaves fit them
# (`csrc/ptraverse.cuh` LEAF_SHIFT); the count takes the 9 bits above
LEAF_SHIFT = 22
RECORD_WORDS = 16  # node_records
LINK_RECORD_WORDS = 8  # link_records
_I32_MAX = (1 << 31) - 1


@dataclasses.dataclass
class PackedBVH:
    nodes: np.ndarray  # int32 [M, NODE_WORDS]
    tris: np.ndarray  # float32 [S, 9]
    shade: np.ndarray  # float32 [S, 16], meta word (or material id) in lane 15
    root: int
    depth: int  # depth of the deepest tree, root level = 1
    links: np.ndarray | None  # int32 [M, 16] per-octant (hit, miss) links, or None
    roots: tuple  # the roots in walk order (one, unless a forest)
    node_records: np.ndarray  # int32 [M, RECORD_WORDS]
    record_root: int  # root, or ~root for a one-leaf tree
    link_records: np.ndarray | None  # int32 [8, M, LINK_RECORD_WORDS], or None
    tris4: np.ndarray  # float32 [S, 12]
    slot_ids: np.ndarray | None  # int32 [S, 4] (tri, obj, mat, 0), None where the meta word fits
    stack: bool  # the binary stack walk serves the tree (a BVH of depth <= STACK_CAP)
    cell_forest: bool  # a grid or KD cell forest (links given by `accel/cell_tree.py`)
    leaf_codes: bool  # leaf codes carry the count (module docstring), else the first slot alone


def codes_fit(first: np.ndarray, count: np.ndarray) -> bool:
    """Whether every leaf (`first`, `count`) fits `count << LEAF_SHIFT |
    first` in 31 bits."""
    first, count = np.asarray(first, np.int64), np.asarray(count, np.int64)
    return not first.size or bool(first.max() < (1 << LEAF_SHIFT)
                                  and count.max() < (1 << (31 - LEAF_SHIFT)))


def leaf_refs(first: np.ndarray, count: np.ndarray, codes: bool) -> np.ndarray:
    """`~code` (int32, negative) per leaf, the walk records' leaf ref: the
    code is `count << LEAF_SHIFT | first` with `codes`, else `first`."""
    first, count = np.asarray(first, np.int64), np.asarray(count, np.int64)
    if first.size and (first.min() < 0 or first.max() > _I32_MAX):
        raise ValueError("a leaf's first slot does not fit an int32 word")
    if codes and not codes_fit(first, count):
        raise ValueError(f"a leaf does not fit count << {LEAF_SHIFT} | first")
    code = (count << LEAF_SHIFT) | first if codes else first
    return (~code).astype(np.int32)


def node_records(nodes: np.ndarray, root: int, codes: bool) -> tuple[np.ndarray, int]:
    """The binary stack walk's table (module docstring) from `nodes`, and
    the walk's start: (int32 [M, RECORD_WORDS], record_root).  Raises
    unless every node without triangles has two distinct children."""
    m = nodes.shape[0]
    count = nodes[:, N_COUNT]
    nearfar = nodes[:, N_NEARFAR:].reshape(m, 8, 2)
    # refs of every node as a child: its id, or ~code for a leaf
    ref = np.arange(m, dtype=np.int32)
    leaf = count > 0
    ref[leaf] = leaf_refs(nodes[leaf, N_FIRST], count[leaf], codes)
    rec = np.zeros((m, RECORD_WORDS), np.int32)
    interior = np.nonzero(~leaf)[0]
    # octant 0 (no negative component) takes the left child first
    left, right = nearfar[interior, 0, 0], nearfar[interior, 0, 1]
    bad = (left < 0) | (right < 0) | (left == right)
    if bad.any():
        raise ValueError(f"interior node {int(interior[bad][0])} has not two children")
    rec[interior, 0:6] = nodes[left, N_BMIN : N_BMAX + 3]
    rec[interior, 6:12] = nodes[right, N_BMIN : N_BMAX + 3]
    rec[interior, 12] = ref[left]
    rec[interior, 13] = ref[right]
    near = nearfar[interior, :, 0]  # [I, 8]
    if not ((near == left[:, None]) | (near == right[:, None])).all():
        raise ValueError("a near child is neither of its node's children")
    rec[interior, 14] = ((near == right[:, None]) << np.arange(8)).sum(axis=1)
    if leaf[root]:
        rec[root, 0:6] = nodes[root, N_BMIN : N_BMAX + 3]
        rec[root, 12] = ref[root]
        return rec, ~int(root)
    return rec, int(root)


def link_records(nodes: np.ndarray, links: np.ndarray, codes: bool) -> np.ndarray:
    """The link walk's table (module docstring) from `nodes` and `links`
    [M, 16]: int32 [8, M, LINK_RECORD_WORDS]."""
    m = nodes.shape[0]
    leaf = nodes[:, N_COUNT] > 0
    hit_miss = links.reshape(m, 8, 2).transpose(1, 0, 2)  # [8, M, 2]
    rec = np.zeros((8, m, LINK_RECORD_WORDS), np.int32)
    rec[:, :, 0:6] = nodes[None, :, N_BMIN : N_BMAX + 3]
    rec[:, :, 6] = hit_miss[:, :, 0]
    rec[:, leaf, 6] = leaf_refs(nodes[leaf, N_FIRST], nodes[leaf, N_COUNT], codes)[None]
    rec[:, :, 7] = hit_miss[:, :, 1]
    return rec


def tris4(tris: np.ndarray, first: np.ndarray, count: np.ndarray) -> np.ndarray:
    """`tris` [S, 9] with v0, e1, e2 each padded to four floats: [S, 12];
    word 3 of each slot of a leaf (`first`, `count` per leaf) holds, bit
    cast, the slots from it to the leaf's end.  Raises where two leaves
    share a slot with different ends."""
    s = tris.shape[0]
    out = np.zeros((s, 3, 4), np.float32)
    out[:, :, :3] = np.asarray(tris, np.float32).reshape(-1, 3, 3)
    first, count = np.asarray(first, np.int64), np.asarray(count, np.int64)
    if count.size and (count.min() < 1 or (first + count).max() > s):
        raise ValueError("a leaf's slots lie outside the triangle table")
    # every leaf's slots, leaf after leaf, and the slots left from each
    rank = np.arange(count.sum()) - np.repeat(np.cumsum(count) - count, count)
    slots = np.repeat(first, count) + rank
    left = np.repeat(count, count) - rank
    words = out.view(np.int32)[:, 0, 3]
    words[slots] = left
    if not (words[slots] == left).all():
        raise ValueError("two leaves share a triangle slot with different ends")
    return out.reshape(-1, 12)


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


def meta_fits(obj_id: np.ndarray, mat_id: np.ndarray) -> bool:
    """Whether every triangle's ids fit the meta word: tri 20 bits, obj 6,
    mat 5, so that the sign bit stays clear (the JAX package's
    `ids_packable`, accel/pack.py:266-292 there)."""
    return (obj_id.shape[0] < (1 << 20) and obj_id.max(initial=0) < (1 << 6)
            and mat_id.max(initial=0) < (1 << 5))


def meta_words(obj_id: np.ndarray, mat_id: np.ndarray) -> np.ndarray:
    """Per-triangle `tri | obj << 20 | mat << 26` (int32); `meta_fits`
    must hold."""
    return (
        np.arange(obj_id.shape[0], dtype=np.int32)
        | (obj_id.astype(np.int32) << 20)
        | (mat_id.astype(np.int32) << 26)
    )


def slot_id_table(slot_tri: np.ndarray, obj_id: np.ndarray, mat_id: np.ndarray) -> np.ndarray:
    """int32 [S, 4]: each slot's (tri, obj, mat, 0), the ids of a scene
    whose meta word does not fit."""
    out = np.zeros((slot_tri.shape[0], 4), np.int32)
    out[:, 0] = slot_tri
    out[:, 1] = obj_id[slot_tri]
    out[:, 2] = mat_id[slot_tri]
    return out


def _children(nearfar: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(left, right, split axis) per node from its per-octant near/far
    table: octant 0 takes the left child first, and the octant of the one
    negative axis that swaps the pair names the split axis."""
    left, right = nearfar[0, 0], nearfar[0, 1]
    axis = np.zeros(left.shape[0], np.int32)
    for a in (1, 2):
        axis = np.where(nearfar[1 << a, 0] != left, a, axis)
    return left, right, axis


def make_tables(
    node_min, node_max, first, count, nearfar, tris, shade, root: int, depth: int,
    links=None, roots=None, slot_ids=None,
) -> PackedBVH:
    """Assemble the node records.  `nearfar` int32 [8, 2, M]; `links`
    (hit, miss) int32 [8, M] each for a cell forest, which is walked by
    them and needs no stack.  A BVH deeper than STACK_CAP is threaded here
    (`bvh_builder.thread_links` over the children `nearfar` names) and
    walked by links as well."""
    m = node_min.shape[0]
    cell_forest = links is not None
    roots = tuple(int(r) for r in (roots or [root]))
    if links is None and depth > STACK_CAP:
        left, right, axis = _children(np.asarray(nearfar))
        links = bvh_builder.thread_links(left, right, np.asarray(count), axis, roots=roots)
    if links is not None:
        links = np.stack(links, axis=2).astype(np.int32).transpose(1, 0, 2).reshape(m, 16)
    nodes = np.zeros((m, NODE_WORDS), np.int32)
    nodes[:, N_BMIN : N_BMIN + 3] = np.asarray(node_min, np.float32).view(np.int32)
    nodes[:, N_BMAX : N_BMAX + 3] = np.asarray(node_max, np.float32).view(np.int32)
    nodes[:, N_FIRST] = first
    nodes[:, N_COUNT] = count
    nodes[:, N_NEARFAR:] = np.transpose(nearfar, (2, 0, 1)).reshape(m, 16)
    leaf = nodes[:, N_COUNT] > 0
    codes = codes_fit(nodes[leaf, N_FIRST], nodes[leaf, N_COUNT])
    records, record_root = node_records(nodes, int(root), codes)
    return PackedBVH(
        nodes=nodes,
        tris=np.ascontiguousarray(tris, np.float32),
        shade=np.ascontiguousarray(shade, np.float32),
        root=int(root),
        depth=int(depth),
        links=links,
        roots=roots,
        node_records=records,
        record_root=record_root,
        link_records=None if links is None else link_records(nodes, links, codes),
        tris4=tris4(tris, nodes[leaf, N_FIRST], nodes[leaf, N_COUNT]),
        slot_ids=slot_ids,
        stack=links is None,
        cell_forest=cell_forest,
        leaf_codes=codes,
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
    slot_ids = None
    if meta_fits(obj_id, mat_id):
        shade.view(np.int32)[:, 15] = meta_words(obj_id, mat_id)
    else:
        shade[:, 15] = mat_id.astype(np.float32)
        slot_ids = slot_id_table(slot_tri, obj_id, mat_id)
    roots = [root] if roots is None else list(roots)
    depth = max(tree_depth(left, right, r) for r in roots)
    return make_tables(
        node_min, node_max, first, tri_count, nearfar_from_children(left, right, axis),
        tris, shade[slot_tri], root, depth, links=links, roots=roots, slot_ids=slot_ids,
    )
