"""Wide (8-ary) BVH: the binary SAH tree collapsed into nodes of up to 8
children, for the wide walk (`ops/wide_bvh.py`, `csrc/wide_bvh.cu`).

The port of the JAX package's `cpu_ray_tracer_tpu/accel/wide.py`
(`collapse_wide`, `_octant_order`, `pack_wide_host`).  The collapse and the
per-octant child order are the JAX package's, so the tables compare one to
one.  The layout is one record per wide node, as a thread reads it:

* `nodes` int32 [W, 64] (256 bytes per wide node, float fields bit-cast):
  words 6k .. 6k + 5 child k's bmin xyz and bmax xyz (NaN for an empty
  slot: every slab comparison then fails); word 48 + k child k's word;
  word 56 + o the order word of ray-direction octant o, whose bits
  3r .. 3r + 2 name the child slot of rank r, nearest first;
* a child word is 0 for an empty slot, the wide node's index for an
  interior child (never 0: node 0 is the root), and `~code` (negative)
  for a leaf: the binary pack's leaf code (`accel/pack.py` leaf_refs) of
  its slots in the `tris` / `shade` tables, which the wide walk shares, so
  a leaf takes as many slots and triangles as an int32 word counts (the
  JAX package's child word holds a 22-bit row and a 9-bit row count).

The JAX package regroups each wide node's leaf triangles into contiguous
8-triangle rows for its union-row loop (wide_bvh.py:141-152); a thread
here tests each leaf it hits on its own, so the binary slots serve as
they are.

`nodes` is the table that compares one to one with the JAX package's;
the CUDA walk reads `records` (`wide_records`), the same words laid out
for 16-byte loads: the boxes field-major, word 8f + k holding field f
(bmin xyz, bmax xyz) of child k, so that 12 `float4` loads carry the 8
boxes, 4 children each; words 48-63 as in `nodes` (2 `int4` of child
words, then the 8 order words).  The walk keeps the pending interior
children of a step as node ids on a per-thread stack, pushed far to
near, so that a pop is one stack read and never returns to the parent's
record; `stack` is the most such a tree can hold at once (`stack_need`),
checked against `WIDE_STACK_CAP` at pack time.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cpu_ray_tracer_tpu_torch.accel import pack

WIDE = 8  # children per wide node
WIDE_WORDS = 64
W_CHILD = 48
W_ORDER = 56
# per-thread stack capacity of the wide walk (`csrc/ptraverse.cuh`
# WIDE_STACK_CAP), in node ids: up to 7 pending children per level of
# the wide tree, plus the forest's extra roots; every tree of up to 32
# levels fits it
WIDE_STACK_CAP = 256
# wide_records: word 8f + k is box field f of child k
W_FIELDS = 6


@dataclasses.dataclass
class PackedWide:
    nodes: np.ndarray  # int32 [W, WIDE_WORDS]
    records: np.ndarray  # int32 [W, WIDE_WORDS]: `wide_records(nodes)`
    roots: tuple  # wide roots in walk order
    depth: int  # wide-tree depth, root level = 1
    stack: int  # most node ids on the walk's stack at once, one root


def collapse_wide(left, right, tri_count, node_min, node_max, root: int, width: int = WIDE):
    """Collapse a binary BVH into wide nodes, greedily: a wide node starts
    from one binary interior node's two children and repeatedly opens its
    largest-surface-area interior child in place until `width` slots are
    used.  Returns (children, depth): per wide node a list of
    (binary node, wide child index or -1 for a leaf); wide node 0 is the
    root; depth with root level 1."""
    ext = np.maximum(node_max - node_min, 0.0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]
    is_leaf = tri_count > 0
    if is_leaf[root]:
        return [[(root, -1)]], 1

    children: list = [root]  # a binary id until the node is expanded
    depth_of = [1]
    i = 0
    while i < len(children):
        n = children[i]
        kids = [int(left[n]), int(right[n])]
        while len(kids) < width:
            best, best_a = -1, -1.0
            for j, c in enumerate(kids):
                if not is_leaf[c] and area[c] > best_a:
                    best, best_a = j, float(area[c])
            if best < 0:
                break
            c = kids.pop(best)
            kids.extend([int(left[c]), int(right[c])])
        out = []
        for c in kids:
            if is_leaf[c]:
                out.append((c, -1))
            else:
                out.append((c, len(children)))
                children.append(c)
                depth_of.append(depth_of[i] + 1)
        children[i] = out
        i += 1
    return children, max(depth_of)


def octant_order(centers: np.ndarray, octant: int) -> np.ndarray:
    """Near-first child order for rays in `octant` (bit a set: the
    direction is negative along axis a): ascending projection of the child
    box centres onto the octant's sign vector (infra/bvh.cpp:245-249 made
    static)."""
    sign = np.array([-1.0 if (octant >> a) & 1 else 1.0 for a in range(3)], np.float32)
    return np.argsort(centers @ sign, kind="stable")


def wide_records(nodes: np.ndarray) -> np.ndarray:
    """The CUDA walk's records of wide nodes `nodes` [W, WIDE_WORDS]
    (module docstring): word 8f + k of a record is word 6k + f of the node
    (box field f of child k); words 48-63 are the node's."""
    rec = nodes.copy()
    boxes = nodes[:, : W_FIELDS * WIDE].reshape(-1, WIDE, W_FIELDS)
    rec[:, : W_FIELDS * WIDE] = boxes.transpose(0, 2, 1).reshape(-1, W_FIELDS * WIDE)
    return rec


def stack_need(nodes: np.ndarray, root: int = 0) -> int:
    """The most node ids the walk's stack holds at once below `root`: a
    step over a node with c interior children pushes c - 1 of them and
    enters the last, so the need of a node is c - 1 plus the largest need
    of its interior children (0 for a node without any)."""
    child = nodes[:, W_CHILD : W_CHILD + WIDE]
    need = np.zeros(nodes.shape[0], np.int64)
    # children have larger indices than their parent (collapse_wide's
    # breadth-first numbering), so one pass from the last node up
    for w in range(nodes.shape[0] - 1, -1, -1):
        kids = child[w][child[w] > 0]
        if kids.size:
            need[w] = kids.size - 1 + need[kids].max()
    return int(need[root])


def pack_wide(node_min, node_max, left, right, tri_count, root: int, first, count,
              codes: bool) -> PackedWide:
    """Collapse and pack a binary host BVH (the fused TLAS forest has one
    root) whose leaves hold the binary pack's slots [first, first + count)
    (per binary node, `accel/pack.py` N_FIRST / N_COUNT), in the binary
    pack's leaf code form `codes` (`PackedBVH.leaf_codes`)."""
    wide, depth = collapse_wide(left, right, tri_count, node_min, node_max, root)
    w = len(wide)
    roots = (0,)
    nodes = np.zeros((w, WIDE_WORDS), np.int32)
    boxes = np.full((w, 6 * WIDE), np.nan, np.float32)
    for wi, kids in enumerate(wide):
        ids = np.array([c[0] for c in kids], np.int64)
        for slot, (bin_id, wide_child) in enumerate(kids):
            boxes[wi, 6 * slot : 6 * slot + 3] = node_min[bin_id]
            boxes[wi, 6 * slot + 3 : 6 * slot + 6] = node_max[bin_id]
            if wide_child >= 0:
                nodes[wi, W_CHILD + slot] = wide_child
            else:
                if count[bin_id] < 1:
                    raise ValueError(f"leaf {bin_id} holds no triangle")
                nodes[wi, W_CHILD + slot] = pack.leaf_refs(
                    first[bin_id : bin_id + 1], count[bin_id : bin_id + 1], codes)[0]
        centers = (node_min[ids] + node_max[ids]) * 0.5
        for o in range(8):
            # ranks past the node's children name slot 0 again, which is
            # already ranked: a repeat changes nothing
            nodes[wi, W_ORDER + o] = sum(
                int(s) << (3 * r) for r, s in enumerate(octant_order(centers, o)))
    nodes[:, : 6 * WIDE] = boxes.view(np.int32)
    stack = stack_need(nodes)
    check_stack(stack, len(roots))
    return PackedWide(nodes=nodes, records=wide_records(nodes), roots=roots, depth=depth,
                      stack=stack)


def check_stack(stack: int, n_roots: int) -> None:
    """Raise where a walk from `n_roots` roots over a tree of stack need
    `stack` could push past WIDE_STACK_CAP (the kernel does not check)."""
    if stack + n_roots - 1 > WIDE_STACK_CAP:
        raise ValueError(f"the wide walk's stack would hold {stack + n_roots - 1} node ids, "
                         f"past its capacity {WIDE_STACK_CAP}")
