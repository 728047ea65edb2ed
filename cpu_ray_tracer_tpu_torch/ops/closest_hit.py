"""Closest-hit and any-hit queries over the scene's BVH: the CUDA kernels'
wrappers (`closest_hit`, `occluded`) and their plain PyTorch versions
(`closest_hit_plain`, `occluded_plain`).

The port of the JAX package's packet kernel `_kernel_stack` and its
launcher `traverse` (cpu_ray_tracer_tpu/ops/pallas/packet_bvh.py:442-678,
:763-926), in its closest-hit and any-hit modes; the walk is described in
`csrc/ptraverse.cuh`.  `closest_hit` and `closest_hit_plain` take the same
arguments and return the same dict:

    t, u, v      float32 [R]  hit distance (t0 where nothing closer was hit)
                              and barycentrics (0 on a miss)
    slot         int32 [R]    winning triangle slot (-1 on a miss)
    tri_idx, obj_id, mat_id   int32 [R]  ids from the slot's meta word
    traversed, tested         int32 [R]  interior steps, triangle tests

Rays with mask False do nothing: t = t0, slot -1, counters 0.
`occluded` and `occluded_plain` return bool [R]: a hit exists in
(TRI_EPS, t0) (False where mask is False).

Each wrapper runs the plain version for tensors on the CPU and launches
the kernel for tensors on a CUDA device; there is no other fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch import constants
from cpu_ray_tracer_tpu_torch.accel.pack import N_COUNT, N_FIRST, N_NEARFAR
from cpu_ray_tracer_tpu_torch.ops import kernel_lib

_TINY = np.float32(1e-30)
_TRI_EPS = constants.TRI_EPS


def _outputs(t0: torch.Tensor) -> dict:
    r, dev = t0.shape[0], t0.device
    i32 = dict(dtype=torch.int32, device=dev)
    return dict(
        t=t0.clone(),
        u=torch.zeros(r, dtype=torch.float32, device=dev),
        v=torch.zeros(r, dtype=torch.float32, device=dev),
        slot=torch.full((r,), -1, **i32),
        traversed=torch.zeros(r, **i32),
        tested=torch.zeros(r, **i32),
    )


def _decode(shade: torch.Tensor, res: dict) -> dict:
    """Hit ids from the meta word in lane 15 of the winning slot's shading
    record (packet_bvh.py:898-908)."""
    slot = res["slot"]
    meta = shade[slot.clamp_min(0).long(), 15].view(torch.int32)
    found = (slot >= 0) & (meta >= 0)
    minus1 = torch.full_like(meta, -1)
    res["tri_idx"] = torch.where(found, meta & 0xFFFFF, minus1)
    res["obj_id"] = torch.where(found, (meta >> 20) & 0x3F, minus1)
    res["mat_id"] = torch.where(found, (meta >> 26) & 0x3F, minus1)
    return res


def _slab(bounds, o, rd, t):
    """packet_bvh.py:572-589.  torch.minimum/maximum propagate NaN as
    jnp.minimum/maximum do, and a NaN makes the test fail."""
    t1 = (bounds[:, 0:3] - o) * rd
    t2 = (bounds[:, 3:6] - o) * rd
    lo = torch.minimum(t1, t2)
    hi = torch.maximum(t1, t2)
    tmin = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    tmax = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    return (tmax >= tmin) & (tmin < t) & (tmax > 0.0)


def _leaf_tests(tris, ids, first, count, o, d, res):
    """Moller-Trumbore (packet_bvh.py:521-549) of the rays `ids` against
    their leaves' slots [first, first + count), slot k of every ray at
    once, in slot order."""
    if ids.numel() == 0:
        return
    t, u, v, slot = res["t"], res["u"], res["v"], res["slot"]
    for k in range(int(count.max())):
        m = k < count
        rid = ids[m]
        s = first[m] + k
        tri = tris[s.long()]
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri.unbind(1)
        ox, oy, oz = o[rid].unbind(1)
        dx, dy, dz = d[rid].unbind(1)
        hx = dy * e2z - dz * e2y
        hy = dz * e2x - dx * e2z
        hz = dx * e2y - dy * e2x
        a = e1x * hx + e1y * hy + e1z * hz
        f = 1.0 / torch.where(a.abs() < _TINY, _TINY, a)
        sx = ox - v0x
        sy = oy - v0y
        sz = oz - v0z
        uu = f * (sx * hx + sy * hy + sz * hz)
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        vv = f * (dx * qx + dy * qy + dz * qz)
        tt = f * (e2x * qx + e2y * qy + e2z * qz)
        ok = (
            (a.abs() >= _TRI_EPS) & (uu >= 0.0) & (uu <= 1.0) & (vv >= 0.0)
            & (uu + vv <= 1.0) & (tt > _TRI_EPS) & (tt < t[rid])
        )
        w = rid[ok]
        t[w] = tt[ok]
        u[w] = uu[ok]
        v[w] = vv[ok]
        slot[w] = s[ok].to(torch.int32)
    res["tested"][ids] += count


def _walk_plain(scene, o, d, t0, mask, any_hit: bool) -> dict:
    """The kernel's walk in plain PyTorch, lockstep over the rays: each
    round every unfinished ray takes one step of its own walk, in the
    kernel's order.  With `any_hit` a ray stops after the step in which it
    accepted a triangle (the kernel stops at that triangle; the boolean is
    the same)."""
    nodes, tris = scene.nodes, scene.tris
    r, dev = o.shape[0], o.device
    res = _outputs(t0)
    live = torch.ones(r, dtype=torch.bool, device=dev) if mask is None else mask.bool()
    rd = 1.0 / d
    octant = (d[:, 0] < 0).long() + 2 * (d[:, 1] < 0).long() + 4 * (d[:, 2] < 0).long()
    fnodes = nodes.view(torch.float32)
    if scene.root_is_leaf:
        # a one-leaf tree: no interior node to step on; its box, then its
        # triangles
        ids = torch.nonzero(live).squeeze(1)
        box = fnodes[scene.root, 0:6].expand(ids.numel(), 6)
        ids = ids[_slab(box, o[ids], rd[ids], res["t"][ids])]
        rec = nodes[scene.root]
        n = ids.numel()
        _leaf_tests(tris, ids, rec[N_FIRST].expand(n), rec[N_COUNT].expand(n), o, d, res)
        return res

    cur = torch.where(live, scene.root, -1).long()
    stack = torch.full((r, max(scene.depth, 1)), -1, dtype=torch.long, device=dev)
    sp = torch.zeros(r, dtype=torch.long, device=dev)
    while True:
        ids = torch.nonzero(cur >= 0).squeeze(1)
        if ids.numel() == 0:
            break
        c = cur[ids]
        col = N_NEARFAR + 2 * octant[ids]
        near = nodes[c, col].long()
        far = nodes[c, col + 1].long()
        t = res["t"][ids]
        hit_n = _slab(fnodes[near, 0:6], o[ids], rd[ids], t)
        hit_f = _slab(fnodes[far, 0:6], o[ids], rd[ids], t)
        count_n, count_f = nodes[near, N_COUNT], nodes[far, N_COUNT]
        for hit, child, count in ((hit_n, near, count_n), (hit_f, far, count_f)):
            m = hit & (count > 0)
            _leaf_tests(tris, ids[m], nodes[child[m], N_FIRST], count[m], o, d, res)
        go_n = hit_n & (count_n == 0)
        go_f = hit_f & (count_f == 0)
        both = go_n & go_f
        sp_ids = sp[ids]
        stack[ids[both], sp_ids[both]] = far[both]
        sp_ids = sp_ids + both.long()
        pop = ~(go_n | go_f)
        has = sp_ids > 0
        top = stack[ids, (sp_ids - 1).clamp_min(0)]
        nxt = torch.where(go_n, near, torch.where(go_f, far, torch.where(has, top, -1)))
        if any_hit:
            nxt = torch.where(res["slot"][ids] >= 0, -1, nxt)
        sp[ids] = torch.where(pop & has, sp_ids - 1, sp_ids)
        cur[ids] = nxt
        res["traversed"][ids] += 1
    return res


def closest_hit_plain(scene, o, d, t0, mask=None) -> dict:
    """The kernel's closest-hit walk in plain PyTorch, lockstep over the
    rays, so t/u/v, ids and counters equal the kernel's."""
    return _decode(scene.shade, _walk_plain(scene, o, d, t0, mask, any_hit=False))


def occluded_plain(scene, o, d, t0, mask=None) -> torch.Tensor:
    """Bool [R]: whether a triangle hit exists in (TRI_EPS, t0), by the
    any-hit walk in plain PyTorch."""
    return _walk_plain(scene, o, d, t0, mask, any_hit=True)["slot"] >= 0


def _check(what, o, d, t0, mask, scene):
    r = o.shape[0]
    kernel_lib.require(
        what, o.device,
        o=(o, torch.float32, (r, 3)), d=(d, torch.float32, (r, 3)),
        t0=(t0, torch.float32, (r,)), mask=(mask, torch.bool, (r,)),
        nodes=(scene.nodes, torch.int32, None), tris=(scene.tris, torch.float32, None),
        shade=(scene.shade, torch.float32, None),
    )


def closest_hit(scene, o, d, t0, mask=None) -> dict:
    """Closest hit of rays (o, d) [R, 3] with t0 [R] and mask [R] bool:
    the plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if kernel_lib.on_cpu("closest_hit", o):
        return closest_hit_plain(scene, o, d, t0, mask)
    r = o.shape[0]
    if mask is None:
        mask = torch.ones(r, dtype=torch.bool, device=o.device)
    _check("closest_hit", o, d, t0, mask, scene)
    k = kernel_lib.load()
    f32 = dict(dtype=torch.float32, device=o.device)
    i32 = dict(dtype=torch.int32, device=o.device)
    out = dict(
        t=torch.empty(r, **f32), u=torch.empty(r, **f32), v=torch.empty(r, **f32),
        slot=torch.empty(r, **i32), tri_idx=torch.empty(r, **i32),
        obj_id=torch.empty(r, **i32), mat_id=torch.empty(r, **i32),
        traversed=torch.empty(r, **i32), tested=torch.empty(r, **i32),
    )
    code = k.lib.crt_closest_hit(
        o.data_ptr(), d.data_ptr(), t0.data_ptr(), mask.data_ptr(), r,
        scene.nodes.data_ptr(), scene.tris.data_ptr(), scene.shade.data_ptr(), scene.root,
        *(out[key].data_ptr() for key in (
            "t", "u", "v", "slot", "tri_idx", "obj_id", "mat_id", "traversed", "tested",
        )),
        kernel_lib.stream(o.device),
    )
    kernel_lib.check(k.lib, code, "closest_hit")
    closest_hit.launches += 1
    return out


def occluded(scene, o, d, t0, mask=None) -> torch.Tensor:
    """Any hit of rays (o, d) [R, 3] in (TRI_EPS, t0) [R], for rays with
    mask [R] True: bool [R].  The plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    if kernel_lib.on_cpu("occluded", o):
        return occluded_plain(scene, o, d, t0, mask)
    r = o.shape[0]
    if mask is None:
        mask = torch.ones(r, dtype=torch.bool, device=o.device)
    _check("occluded", o, d, t0, mask, scene)
    k = kernel_lib.load()
    out = torch.empty(r, dtype=torch.bool, device=o.device)
    code = k.lib.crt_occluded(
        o.data_ptr(), d.data_ptr(), t0.data_ptr(), mask.data_ptr(), r,
        scene.nodes.data_ptr(), scene.tris.data_ptr(), scene.root, out.data_ptr(),
        kernel_lib.stream(o.device),
    )
    kernel_lib.check(k.lib, code, "occluded")
    occluded.launches += 1
    return out


closest_hit.launches = 0  # kernel launches since the last reset
occluded.launches = 0
