"""The reference KD walk: the front-to-back descent with a per-ray stack of
the JAX package's `cpu_ray_tracer_tpu/ops/traverse_kd.py` (the
reference's KDTree::IntersectKDTree, infra/kdtree.cpp:144-204), in plain
PyTorch on the scene's device.

A ray is clipped to the root's box.  Each step either descends one
interior node (into the near child, or the far one where the split lies
before the ray's interval; where it crosses both, the far child's
(node, tmin, tmax) goes on the ray's stack of `max_depth + 2` entries,
pushed only while the stack has room), or tests the next `CHUNK`
triangles of a leaf.  A finished leaf pops the top entry with its tmax
clipped to the ray's best t, so a pruned entry collapses (its interval
is empty and no leaf test in it can win) rather than being skipped, as
there; with an empty stack the ray ends.  `traversed` counts interior
descents, `tested` triangle tests.

The stack is three per-ray tensors [R, D]; a push writes and a pop reads
entry `sp` by `scatter` and `gather` in place of JAX's one-hot masked
writes and sums (the same values: only comparisons read a popped t,
where -0 and +0 agree).  The walk loop, the hit dict and the two loop
counts are `ops/traverse_bvh.py`'s.
"""

from __future__ import annotations

import torch

from cpu_ray_tracer_tpu_torch.accel.types import KDTreeArrays, TrianglePool
from cpu_ray_tracer_tpu_torch.ops.traverse_bvh import finish, leaf_test, lockstep, ray_state

CHUNK = 2  # leaf triangles tested per step


def traverse(kd: KDTreeArrays, tris: TrianglePool, o: torch.Tensor, d: torch.Tensor,
             t0: torch.Tensor, any_hit: bool = False, max_steps: int | None = None) -> dict:
    """Closest hit (or any hit) of rays o, d [R, 3] from t0 [R] through
    the KD tree: `ops/traverse_bvh.py`'s dict.  `max_steps` defaults to
    8 M + 16 for M nodes."""
    r = o.shape[0]
    depth_cap = kd.max_depth + 2
    rd = 1.0 / d
    # clip to the root's box
    t1 = (kd.bounds_min - o) * rd
    t2 = (kd.bounds_max - o) * rd
    tn = torch.amax(torch.minimum(t1, t2), dim=-1)
    tf = torch.amin(torch.maximum(t1, t2), dim=-1)
    if max_steps is None:
        max_steps = 8 * kd.num_nodes + 16
    s = ray_state(o, d, t0)
    zero = torch.zeros_like(s["tri"])
    s.update(rd=rd, node=zero, tmin=torch.maximum(tn, torch.zeros_like(tn)),
             tmax=torch.minimum(tf, t0), k=zero, sp=zero,
             stack_node=torch.zeros((r, depth_cap), dtype=torch.int32, device=o.device),
             stack_tmin=torch.zeros((r, depth_cap), dtype=o.dtype, device=o.device),
             stack_tmax=torch.zeros((r, depth_cap), dtype=o.dtype, device=o.device),
             active=(tf >= tn) & (tf > 0.0) & (tn < t0))
    k_tri = max(kd.tri_ids.shape[0] - 1, 0)

    def body(s):
        node, active, tmin, tmax, k = s["node"], s["active"], s["tmin"], s["tmax"], s["k"]
        safe = node.clamp_min(0)
        rec = kd.node[safe]
        axis, first, cnt = rec[:, 0], rec[:, 3], rec[:, 4]
        is_leaf = axis < 0

        # ---- interior descent ----------------------------------------
        descend = active & ~is_leaf
        ax = axis.clamp_min(0)[:, None].long()
        o_ax = s["o"].gather(1, ax)[:, 0]
        split = kd.split_dist[safe]
        t_split = (split - o_ax) * s["rd"].gather(1, ax)[:, 0]
        near_is_left = (o_ax < split) | ((o_ax == split) & (s["d"].gather(1, ax)[:, 0] <= 0))
        near = torch.where(near_is_left, rec[:, 1], rec[:, 2])
        far = torch.where(near_is_left, rec[:, 2], rec[:, 1])
        only_near = (t_split > tmax) | (t_split <= 0.0)
        only_far = (t_split > 0.0) & (t_split < tmin)
        both = descend & ~only_near & ~only_far

        # push the far child where the ray crosses both
        sp = s["sp"]
        top = sp[:, None].long()
        for key, val in (("stack_node", far), ("stack_tmin", t_split), ("stack_tmax", tmax)):
            st = s[key]  # the walk's own tensor: written in place
            st.scatter_(1, top, torch.where(both, val, st.gather(1, top)[:, 0])[:, None])
        sp = sp + (both & (sp < depth_cap - 1)).to(torch.int32)
        node_new = torch.where(descend, torch.where(only_far, far, near), node)
        tmax_new = torch.where(both, torch.minimum(tmax, t_split), tmax)
        tmin_new = torch.where(descend & only_far, torch.maximum(tmin, t_split), tmin)

        # ---- leaf triangle tests -------------------------------------
        leafing = active & is_leaf
        for c in range(CHUNK):
            slot = (first + k + c).clamp(0, k_tri)
            leaf_test(s, tris, kd.tri_ids[slot], leafing & ((k + c) < cnt))
        leaf_done = leafing & ((k + CHUNK) >= cnt)
        k_new = torch.where(leafing, k + CHUNK, torch.where(descend, 0, k))

        # ---- pop on leaf completion (kdtree.cpp:181): the popped entry's
        # tmax clipped to the best t, so a pruned entry collapses ---------
        has_stack = sp > 0
        pop_ok = leaf_done & has_stack
        sp_pop = (sp - pop_ok.to(torch.int32))[:, None].long()
        node_new = torch.where(pop_ok, s["stack_node"].gather(1, sp_pop)[:, 0], node_new)
        tmin_new = torch.where(pop_ok, s["stack_tmin"].gather(1, sp_pop)[:, 0], tmin_new)
        tmax_new = torch.where(pop_ok, torch.minimum(s["stack_tmax"].gather(1, sp_pop)[:, 0],
                                                     s["t"]), tmax_new)
        s["k"] = torch.where(pop_ok, 0, k_new)
        s["sp"] = torch.where(pop_ok, sp_pop[:, 0].to(torch.int32), sp)
        s["node"], s["tmin"], s["tmax"] = node_new, tmin_new, tmax_new
        active = active & ~(leaf_done & ~has_stack)
        s["active"] = active & (s["tri"] < 0) if any_hit else active
        s["traversed"] = s["traversed"] + descend.to(torch.int32)

    return finish(tris, lockstep(s, body, lambda s: s["active"], max_steps))
