"""Grid and KD tree as cell forests: the port of the JAX package's
`cpu_ray_tracer_tpu/accel/cell_tree.py` (`tree_from_grid`, `tree_from_kd`,
`merge_trees`, `pack_tree`), step for step, so that both packages compile
the same tree with the same node numbering and leaf triangle order.

The reference walks its grid by DDA (infra/grid.cpp:94-153) and its KD
tree by recursive descent (infra/kdtree.cpp:144-204).  Both answer the
question "which triangle lists can this ray's interval touch, nearest
first" over a tree of axis-aligned regions, so both compile to one form: a
binary tree with per-octant hit/miss links, walked by the link walk
(`ops/link_walk.py`).

* Grid: the build is unchanged (`accel/grid_builder.py`); the non-empty
  cells become leaves of a median-split binary tree over the cell lattice,
  small cell groups merged into one leaf (triangles deduplicated).
* KD tree: the build is unchanged (`accel/kdtree_builder.py`); interior
  nodes carry their implied split bounds, small subtrees collapse into one
  leaf (straddle duplicates deduplicated), empty subtrees are contracted
  away; leaf bounds are clipped to their triangles' bounding union when
  the caller gives `tri_bounds`.

A triangle may sit in several leaves (grid cells insert every triangle
their box overlaps; KD straddlers): hits compare by triangle id, not slot.
All host-side numpy.
"""

from __future__ import annotations

import numpy as np

from cpu_ray_tracer_tpu_torch.accel import bvh_builder, pack


def _new_tree():
    return dict(node_min=[], node_max=[], left=[], right=[], axis=[], left_first=[],
                tri_count=[], tri_indices=[], cursor=0)


def _emit_leaf(tree, bmin, bmax, tri_ids):
    tree["node_min"].append(bmin)
    tree["node_max"].append(bmax)
    tree["left"].append(-1)
    tree["right"].append(-1)
    tree["axis"].append(0)
    tree["left_first"].append(tree["cursor"])
    tree["tri_count"].append(len(tri_ids))
    tree["tri_indices"].append(np.asarray(tri_ids, np.int32))
    tree["cursor"] += len(tri_ids)
    return len(tree["node_min"]) - 1


def _emit_interior(tree, bmin, bmax, axis):
    tree["node_min"].append(bmin)
    tree["node_max"].append(bmax)
    tree["left"].append(-1)
    tree["right"].append(-1)
    tree["axis"].append(axis)
    tree["left_first"].append(0)
    tree["tri_count"].append(0)
    return len(tree["node_min"]) - 1


def _finish(tree) -> dict:
    return dict(
        node_min=np.asarray(tree["node_min"], np.float32).reshape(-1, 3),
        node_max=np.asarray(tree["node_max"], np.float32).reshape(-1, 3),
        left=np.asarray(tree["left"], np.int32),
        right=np.asarray(tree["right"], np.int32),
        axis=np.asarray(tree["axis"], np.int32),
        left_first=np.asarray(tree["left_first"], np.int32),
        tri_count=np.asarray(tree["tri_count"], np.int32),
        tri_indices=(np.concatenate(tree["tri_indices"]) if tree["tri_indices"]
                     else np.zeros(0, np.int32)),
        root=0,
    )


def _budgeted(build, host: dict, leaf_target: int, max_nodes: int | None) -> dict:
    """Double `leaf_target` until the tree has at most `max_nodes` nodes.
    Coarser leaves are unions of finer ones, so the hits are the same."""
    t = leaf_target
    while True:
        tree = build(host, t)
        if max_nodes is None or tree["left"].shape[0] <= max_nodes or t > 1 << 20:
            return tree
        t *= 2


def tree_from_grid(ghost: dict, leaf_target: int = 24, max_nodes: int | None = 8192) -> dict:
    """Cell tree of a grid (`grid_builder.build_grid`'s dict; triangle ids
    are taken as they are, so a forest's may be offset), within the node
    budget."""
    return _budgeted(_tree_from_grid, ghost, leaf_target, max_nodes)


def _tree_from_grid(ghost: dict, leaf_target: int) -> dict:
    """Median-split binary tree over the grid's non-empty cells."""
    rx, ry, rz = ghost["resolution"]
    cs = np.asarray(ghost["cell_start"], np.int64)
    ct = np.asarray(ghost["cell_tris"], np.int32)
    lens = np.diff(cs)
    nz = np.nonzero(lens)[0]
    bmin0 = np.asarray(ghost["bounds_min"], np.float64)
    cell_sz = (np.asarray(ghost["bounds_max"], np.float64) - bmin0) / np.array(
        [rx, ry, rz], np.float64)

    tree = _new_tree()
    if nz.size == 0:
        _emit_leaf(tree, np.zeros(3, np.float32), np.full(3, -1.0, np.float32), [])
        return _finish(tree)

    ijk = np.stack([nz % rx, (nz // rx) % ry, nz // (rx * ry)], axis=1).astype(np.float64)
    cmin = bmin0 + ijk * cell_sz
    cmax = cmin + cell_sz
    cell_lens = lens[nz]

    def emit(sel):  # sel: index array into nz
        gmin = cmin[sel].min(axis=0).astype(np.float32)
        gmax = cmax[sel].max(axis=0).astype(np.float32)
        if sel.size == 1 or int(cell_lens[sel].sum()) <= leaf_target:
            # a triangle in several member cells is tested once per leaf
            ids = np.unique(np.concatenate([ct[cs[nz[s]] : cs[nz[s] + 1]] for s in sel]))
            return _emit_leaf(tree, gmin, gmax, ids)
        axis = int(np.argmax(gmax - gmin))
        order = np.argsort((cmin[sel, axis] + cmax[sel, axis]) * 0.5, kind="stable")
        half = sel.size // 2
        node = _emit_interior(tree, gmin, gmax, axis)
        tree["left"][node] = emit(sel[order[:half]])
        tree["right"][node] = emit(sel[order[half:]])
        return node

    emit(np.arange(nz.size))
    return _finish(tree)


def tree_from_kd(khost: dict, leaf_target: int = 24, max_nodes: int | None = 8192) -> dict:
    """Cell tree of a KD tree (`kdtree_builder.build_kdtree`'s dict, with an
    optional `tri_bounds` [N, 2, 3] for clipping leaf bounds), within the
    node budget."""
    return _budgeted(_tree_from_kd, khost, leaf_target, max_nodes)


def _tree_from_kd(khost: dict, leaf_target: int) -> dict:
    """Collapse and bound the KD tree: implied split bounds from the root
    down; a subtree of at most `leaf_target` distinct triangles becomes one
    leaf; an interior node with an empty child is contracted to the other
    child."""
    sa = np.asarray(khost["split_axis"], np.int32)
    sd = np.asarray(khost["split_dist"], np.float32)
    left = np.asarray(khost["left"], np.int32)
    right = np.asarray(khost["right"], np.int32)
    first = np.asarray(khost["first"], np.int32)
    count = np.asarray(khost["count"], np.int32)
    tri_ids = np.asarray(khost["tri_ids"], np.int32)
    tri_bb = khost.get("tri_bounds")

    # subtree totals (children are numbered after parents: reverse order)
    total = count.astype(np.int64).copy()
    for i in range(sa.shape[0] - 1, -1, -1):
        if sa[i] >= 0:
            total[i] = total[left[i]] + total[right[i]]

    def gather_ids(node):
        out, stack = [], [node]
        while stack:
            n = stack.pop()
            if sa[n] >= 0:
                stack.append(left[n])
                stack.append(right[n])
            elif count[n]:
                out.append(tri_ids[first[n] : first[n] + count[n]])
        return np.unique(np.concatenate(out)) if out else np.zeros(0, np.int32)

    tree = _new_tree()

    def emit(node, bmin, bmax):
        while sa[node] >= 0:  # contract through empty children
            le, re_ = total[left[node]] > 0, total[right[node]] > 0
            if le and re_:
                break
            a, dsplit = int(sa[node]), sd[node]
            if le:
                bmax = bmax.copy()
                bmax[a] = dsplit
                node = left[node]
            else:
                bmin = bmin.copy()
                bmin[a] = dsplit
                node = right[node]
        # collapse on the distinct id count; the duplicated total only
        # gates whether gathering is worth trying
        ids = None
        if sa[node] < 0:
            ids = gather_ids(node)
        elif total[node] <= 32 * leaf_target:
            ids = gather_ids(node)
            if ids.size > leaf_target:
                ids = None
        if ids is not None:
            gmin, gmax = bmin, bmax
            if tri_bb is not None and ids.size:
                gmin = np.maximum(bmin, tri_bb[ids, 0].min(axis=0)).astype(np.float32)
                gmax = np.minimum(bmax, tri_bb[ids, 1].max(axis=0)).astype(np.float32)
            return _emit_leaf(tree, gmin.astype(np.float32), gmax.astype(np.float32), ids)
        a, dsplit = int(sa[node]), sd[node]
        me = _emit_interior(tree, bmin.astype(np.float32), bmax.astype(np.float32), a)
        lmax = bmax.copy()
        lmax[a] = dsplit
        rmin = bmin.copy()
        rmin[a] = dsplit
        tree["left"][me] = emit(left[node], bmin.copy(), lmax)
        tree["right"][me] = emit(right[node], rmin, bmax.copy())
        return me

    if total[0] == 0:
        _emit_leaf(tree, np.zeros(3, np.float32), np.full(3, -1.0, np.float32), [])
        return _finish(tree)
    emit(0, np.asarray(khost["bounds_min"], np.float32).copy(),
         np.asarray(khost["bounds_max"], np.float32).copy())
    return _finish(tree)


def merge_trees(trees: list[dict]) -> tuple[dict, list[int]]:
    """Concatenate per-instance trees into one forest, node and triangle
    offsets applied: (merged tree, its root list)."""
    keys = ("node_min", "node_max", "left", "right", "axis", "left_first", "tri_count",
            "tri_indices")
    parts = {k: [] for k in keys}
    roots, node_base, tri_base = [], 0, 0
    for t in trees:
        roots.append(node_base + t["root"])
        for k in ("node_min", "node_max", "axis", "tri_count", "tri_indices"):
            parts[k].append(t[k])
        for k in ("left", "right"):
            parts[k].append(np.where(t[k] >= 0, t[k] + node_base, -1))
        parts["left_first"].append(t["left_first"] + tri_base)
        node_base += t["left"].shape[0]
        tri_base += t["tri_indices"].shape[0]
    merged = {k: np.concatenate(v) for k, v in parts.items()}
    merged["root"] = roots[0]
    return merged, roots


def pack_tree(tree: dict, tri_v, shade16, obj_id, mat_id, roots=None) -> pack.PackedBVH:
    """Thread a (merged) cell tree with per-octant links and pack it over
    triangles `tri_v` [N, 3, 3] (`pack.pack_bvh`; the link table and the
    root list ride along)."""
    roots = [tree["root"]] if roots is None else list(roots)
    hit, miss = bvh_builder.thread_links(
        tree["left"], tree["right"], tree["tri_count"], tree["axis"], roots=roots)
    return pack.pack_bvh(
        tree["node_min"], tree["node_max"], tree["left"], tree["right"], tree["axis"],
        tree["left_first"], tree["tri_count"], tree["tri_indices"], tri_v, shade16,
        obj_id, mat_id, root=roots[0], links=(hit, miss), roots=roots,
    )
