"""The reference BVH walk: the stackless threaded walk of the JAX package's
`cpu_ray_tracer_tpu/ops/traverse_bvh.py` (`traverse` :42, `ray_octants`
:32, `interpolate_hit` :155), in plain PyTorch on the scene's device.

Every ray carries one cursor into the threaded node tables
(`accel/types.BVHArrays`).  One step gathers the cursor's node, slab-tests
it against the ray's current best t, tests the leaf's triangles
(Moller-Trumbore, unrolled to the tree's `max_leaf`) and follows the
ray's octant's hit link (an interior node whose box it hits) or miss link.
A ray parks at cursor -1; `any_hit` parks it at its first recorded hit.
Counters per ray, as the reference's Ray (template/ray.h:33-39):
`traversed` counts the steps a ray is active, box hit or not; `tested`
its triangle tests.

`lockstep` runs a walk's steps (the three reference walks share it).  A
step on a parked ray changes nothing a walk returns, so it checks for
live rays once every `CHECK_EVERY` steps (one host sync), not every step
as the JAX package's `while_loop` does, and then drops the parked rays
from the state; `max_steps` still ends the walk after exactly that many
steps, as there.  No kernel runs here: on the card every step is a train
of small PyTorch operations.

The walks return the port's hit dict (`ops/closest_hit.py`): `t`, `u`,
`v` (the JAX package's `bary` split), `tri_idx` (the pool id, -1 on a
miss), `obj_id`, `mat_id`, `traversed`, `tested`, and two Python ints:
`loop_steps` (steps run) and `syncs` (host syncs).
"""

from __future__ import annotations

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch.accel.types import BVHArrays, TrianglePool
from cpu_ray_tracer_tpu_torch.ops import intersect

CHECK_EVERY = 8  # loop steps between two checks for live rays


def ray_octants(d: torch.Tensor) -> torch.Tensor:
    """Octant id per ray [R] (int64): bit a set where d[:, a] < 0; it picks
    which of the 8 link orders a ray follows."""
    return (d[:, 0] < 0).long() + 2 * (d[:, 1] < 0).long() + 4 * (d[:, 2] < 0).long()


def ray_state(o: torch.Tensor, d: torch.Tensor, t0: torch.Tensor) -> dict:
    """The per-ray tensors every walk starts from: the ray and its lane
    rolls (`intersect.roll3`), the best hit so far (t = t0, no triangle)
    and zero counters.  The floats keep the rays' dtype (float32; the
    tests' float64 check of borderline rays walks float64 rays and
    tables)."""
    r = o.shape[0]
    i32 = dict(dtype=torch.int32, device=o.device)
    o_r, d_r = intersect.roll3(o), intersect.roll3(d)
    return dict(o=o, o_yzx=o_r[0], o_zxy=o_r[1], d=d, d_yzx=d_r[0], d_zxy=d_r[1],
                t=t0.to(o.dtype).clone(), u=torch.zeros_like(t0, dtype=o.dtype),
                v=torch.zeros_like(t0, dtype=o.dtype), tri=torch.full((r,), -1, **i32),
                traversed=torch.zeros(r, **i32), tested=torch.zeros(r, **i32))


def leaf_test(s: dict, tris: TrianglePool, tid: torch.Tensor, ok: torch.Tensor) -> None:
    """Moller-Trumbore of the rays of `s` against pool triangles `tid` [R]
    where `ok`: a hit closer than the ray's t becomes its best hit, and
    every test where `ok` counts."""
    row = tris.rows.index_select(0, tid)
    tk, uk, vk, hk = intersect.mt_rolled(
        s["o"], (s["o_yzx"], s["o_zxy"]), s["d"], (s["d_yzx"], s["d_zxy"]),
        row[:, 0:3], (row[:, 9:12], row[:, 12:15]), row[:, 3:6], (row[:, 15:18], row[:, 18:21]),
        row[:, 6:9], (row[:, 21:24], row[:, 24:27]), s["t"])
    hk = hk & ok
    s["t"] = torch.where(hk, tk, s["t"])
    s["u"] = torch.where(hk, uk, s["u"])
    s["v"] = torch.where(hk, vk, s["v"])
    s["tri"] = torch.where(hk, tid, s["tri"])
    s["tested"] = s["tested"] + ok.to(torch.int32)


_OUT = ("t", "u", "v", "tri", "traversed", "tested")


def lockstep(s: dict, step, active, max_steps: int) -> dict:
    """Run `step(s)` (which replaces per-ray tensors of `s`) up to
    `max_steps` times, until `active(s)` is False for every ray, checking
    every CHECK_EVERY steps and dropping the parked rays from `s` there.
    Every tensor of `s` is per ray.  Returns the rays' t, u, v, tri and
    counters in the input order, with `loop_steps` and `syncs`."""
    out, ids = None, None  # ids: the input rows of the rays still in `s`
    steps = syncs = 0
    while steps < max_steps and s["t"].shape[0] > 0:
        n = min(CHECK_EVERY, max_steps - steps)
        for _ in range(n):
            step(s)
        steps += n
        live = torch.nonzero(active(s)).squeeze(1)
        syncs += 1
        if live.numel() == s["t"].shape[0]:
            continue
        if out is None:
            out = {k: s[k] for k in _OUT}
        else:
            for k in _OUT:
                out[k].index_copy_(0, ids, s[k])
        ids = live if ids is None else ids[live]
        s = {k: x.index_select(0, live) for k, x in s.items()}
    if out is None:
        out = {k: s[k] for k in _OUT}
    elif ids.numel():
        for k in _OUT:
            out[k].index_copy_(0, ids, s[k])
    return dict(out, loop_steps=steps, syncs=syncs)


def finish(tris: TrianglePool, out: dict) -> dict:
    """The walk's hit dict (module docstring) from `lockstep`'s output."""
    tri = out.pop("tri")
    found = tri >= 0
    ts = tri.clamp_min(0)
    minus1 = torch.full_like(tri, -1)
    return dict(out, tri_idx=tri, obj_id=torch.where(found, tris.obj_id[ts], minus1),
                mat_id=torch.where(found, tris.mat_id[ts], minus1))


def traverse(bvh: BVHArrays, tris: TrianglePool, o: torch.Tensor, d: torch.Tensor,
             t0: torch.Tensor, any_hit: bool = False, max_steps: int | None = None) -> dict:
    """Closest hit (or any hit) of rays o, d [R, 3] with t0 [R] the
    initial nearest distance (RAY_FAR, or a shadow ray's length):
    the module docstring's dict.  `max_steps` defaults to 2 M + 4 for M
    nodes (a threaded walk visits each node at most once)."""
    m = bvh.num_nodes
    if max_steps is None:
        max_steps = 2 * m + 4
    s = ray_state(o, d, t0)
    s["rd"] = 1.0 / d
    s["link_base"] = ray_octants(d) * m
    s["cur"] = torch.full_like(s["tri"], bvh.root)
    k_tri = bvh.tri_indices.shape[0]

    def step(s):
        cur = s["cur"]
        active = cur >= 0
        node = cur.clamp_min(0)  # a safe row for parked rays
        box = bvh.box[node]
        _, box_hit = intersect.slab_aabb(s["o"], s["rd"], s["t"], box[:, 0:3], box[:, 3:6])
        box_hit = box_hit & active
        leaf = bvh.leaf[node]
        first, tcount = leaf[:, 0], leaf[:, 1]
        is_leaf = tcount > 0
        do_leaf = box_hit & is_leaf
        for k in range(bvh.max_leaf):
            # JAX clamps out-of-range gathers; the slot of a node with
            # fewer triangles than k is clamped here to the same effect
            slot = (first + torch.clamp_max(tcount - 1, k)).clamp(0, k_tri - 1)
            leaf_test(s, tris, bvh.tri_indices[slot], do_leaf & (k < tcount))
        links = bvh.links[s["link_base"] + node]
        nxt = torch.where(box_hit & ~is_leaf, links[:, 0], links[:, 1])
        if any_hit:
            nxt = torch.where(s["tri"] >= 0, -1, nxt)
        s["cur"] = torch.where(active, nxt, cur)
        s["traversed"] = s["traversed"] + active.to(torch.int32)

    return finish(tris, lockstep(s, step, lambda s: s["cur"] >= 0, max_steps))


def interpolate_hit(shade: torch.Tensor, idx: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """The barycentric-interpolated shading normal (normalised) and uv
    [R, 3], [R, 2] of rows `idx` [R] of a shading table [N, 16] (n0 n1 n2
    uv0 uv1 uv2; `TrianglePool.shade` by pool id, or a scene's `shade` by
    slot), as BVH::GetNormal / GetUV (infra/bvh.cpp:292-306)."""
    rec = shade[idx.clamp_min(0).long()]
    bu, bv = u[:, None], v[:, None]
    w = (1.0 - u - v)[:, None]
    n = w * rec[:, 0:3] + bu * rec[:, 3:6] + bv * rec[:, 6:9]
    uv = w * rec[:, 9:11] + bu * rec[:, 11:13] + bv * rec[:, 13:15]
    sq = (n * n).sum(dim=-1, keepdim=True)
    return n * torch.rsqrt(torch.clamp_min(sq, np.float32(1e-20))), uv
