"""Closest-hit and any-hit queries over the wide (8-ary) BVH
(`accel/wide.py`): the CUDA kernels' wrappers (`closest_hit_wide`,
`occluded_wide`) and their plain PyTorch versions (`closest_hit_wide_plain`,
`occluded_wide_plain`).

The port of the JAX package's wide walk `_kernel`
(cpu_ray_tracer_tpu/ops/pallas/wide_bvh.py:54, launched at :292-335).
There a 4096-ray tile pops one wide node per step under the tile's
majority octant; here each ray walks alone, with its own octant
(`csrc/ptraverse.cuh` `wide_step`).  A step takes one wide node,
slab-tests its 8 child boxes against the ray's current t, tests the
triangles of each hit leaf child in slot order (child 0 first), and goes
on to the nearest hit interior child under the node's order word for the
ray's octant.  The other hit interior children go on the ray's stack as
node ids, far to near, so that a later pop takes the nearest: the pop
order of the JAX kernel's stack word `node << 8 | pending-child mask`
(wide_bvh.py:202-251), without going back to the parent's record.  The
forest's other roots wait on the stack below them, and `accel/wide.py`
checks the stack's capacity at pack time.  `traversed` counts wide-node
steps, `tested` the triangle tests; the any-hit mode stops at the first
accepted triangle.  The kernel reads `wide_records` (the boxes laid out
for 16-byte loads), and so does the plain version.

Same arguments and outputs as `ops/closest_hit.py`, and an optional lane
order `perm` int32 [R] (lane j of the kernel takes ray perm[j]: the
camera's `core/camera.lane_order` for a frame's primary rays), which
moves only which lane walks which ray; the slots are the binary pack's.  Each wrapper runs the plain version for tensors on the CPU
and launches the kernel for tensors on a CUDA device; there is no other
fallback.
"""

from __future__ import annotations

import weakref

import torch

from cpu_ray_tracer_tpu_torch.accel.pack import LEAF_SHIFT
from cpu_ray_tracer_tpu_torch.accel.wide import W_CHILD, W_FIELDS, W_ORDER, WIDE
from cpu_ray_tracer_tpu_torch.ops import kernel_lib
from cpu_ray_tracer_tpu_torch.ops.closest_hit import (
    decode, id_tables, launch_closest, launch_occluded, leaf_tests, octants, outputs, slab,
)


def _bit(s: torch.Tensor) -> torch.Tensor:
    """1 << s, elementwise."""
    return torch.ones_like(s) << s


def leaf_fields(scene, code: torch.Tensor):
    """(first slot, triangle count) of leaf codes (accel/pack.py): count <<
    LEAF_SHIFT | first where the scene's leaves fit, else the first slot,
    whose `tris4` word 3 counts the leaf's slots."""
    if scene.leaf_codes:
        return code & ((1 << LEAF_SHIFT) - 1), (code >> LEAF_SHIFT).to(torch.int32)
    return code, scene.tris4.view(torch.int32)[code.long(), 3]


def _walk_plain(scene, o, d, t0, mask, any_hit: bool) -> dict:
    """The kernel's walk in plain PyTorch over `wide_records`, lockstep
    over the rays: each round every unfinished ray takes one step of its
    own walk.  The pending interior children of a step go on the ray's
    stack as node ids, far to near, so that a pop takes the nearest.  With
    `any_hit` a ray stops after the step in which it accepted a triangle
    (the kernel stops at that triangle; the boolean is the same)."""
    rec, tris = scene.wide_records.long(), scene.tris
    r, dev = o.shape[0], o.device
    res = outputs(t0)
    live = torch.ones(r, dtype=torch.bool, device=dev) if mask is None else mask.bool()
    rd = 1.0 / d
    order_col = W_ORDER + octants(d)
    # word 8f + k: field f of child k
    boxes = (scene.wide_records[:, : W_FIELDS * WIDE].view(torch.float32)
             .reshape(-1, W_FIELDS, WIDE).transpose(1, 2))
    roots = scene.wide_roots.long()
    # forest roots after the first wait on the stack
    cap = max(scene.wide_stack + roots.numel() - 1, 1)
    stack = torch.zeros((r, cap), dtype=torch.long, device=dev)
    stack[:, : roots.numel() - 1] = roots[1:].flip(0)
    sp = torch.full((r,), roots.numel() - 1, dtype=torch.long, device=dev)
    cur = torch.where(live, roots[0], -1)
    ranks = torch.arange(WIDE, device=dev)
    while True:
        ids = torch.nonzero(cur >= 0).squeeze(1)
        if ids.numel() == 0:
            break
        n = ids.numel()
        c = cur[ids]
        row = rec[c]
        child = row[:, W_CHILD : W_CHILD + WIDE]
        hit = slab(
            boxes[c].reshape(-1, 6), o[ids].repeat_interleave(WIDE, 0),
            rd[ids].repeat_interleave(WIDE, 0), res["t"][ids].repeat_interleave(WIDE, 0),
        ).reshape(n, WIDE)
        # a leaf child word is ~code (accel/pack.py leaf_refs)
        leaf = child < 0
        for k in range(WIDE):
            m = hit[:, k] & leaf[:, k]
            first, count = leaf_fields(scene, ~child[m, k])
            leaf_tests(tris, ids[m], first, count, o, d, res)
        bits = ((hit & (child > 0)).long() * _bit(ranks)).sum(1)
        n_int = torch.zeros_like(bits)
        for k in range(WIDE):
            n_int += (bits >> k) & 1
        ow = row.gather(1, order_col[ids, None])[:, 0]
        sp_i = sp[ids]
        top = sp_i + n_int - 1
        # the hit interior children in rank order: the first is the next
        # node, the j-th (j >= 1) goes to stack entry top - j
        nxt = torch.full_like(c, -1)
        j = torch.zeros_like(c)
        for rank in range(WIDE):
            s_ = (ow >> (3 * rank)) & 7
            take = ((bits >> s_) & 1) > 0
            bits = bits & ~(take.long() << s_)
            cw = child.gather(1, s_[:, None])[:, 0]
            nxt = torch.where(take & (j == 0), cw, nxt)
            push = take & (j > 0)
            stack[ids[push], (top - j)[push]] = cw[push]
            j = j + take.long()
        # no interior child hit: pop the nearest pending one
        pop = n_int == 0
        can_pop = pop & (sp_i > 0)
        popped = stack[ids, (sp_i - 1).clamp_min(0)]
        nxt = torch.where(pop, torch.where(can_pop, popped, -1), nxt)
        sp[ids] = torch.where(pop, sp_i - can_pop.long(), top)
        if any_hit:
            nxt = torch.where(res["slot"][ids] >= 0, -1, nxt)
        cur[ids] = nxt
        res["traversed"][ids] += 1
    return res


def closest_hit_wide_plain(scene, o, d, t0, mask=None, perm=None) -> dict:
    """The kernel's closest-hit walk in plain PyTorch, lockstep over the
    rays, so t/u/v, ids and counters equal the kernel's (`perm` changes
    nothing here: each ray's outputs are its own)."""
    return decode(scene, _walk_plain(scene, o, d, t0, mask, any_hit=False))


def occluded_wide_plain(scene, o, d, t0, mask=None, perm=None) -> torch.Tensor:
    """Bool [R]: whether a triangle hit exists in (TRI_EPS, t0), by the
    any-hit wide walk in plain PyTorch."""
    return _walk_plain(scene, o, d, t0, mask, any_hit=True)["slot"] >= 0


# (weak reference, version) of each lane order found to be a permutation,
# by id: the check syncs with the card, and a frame passes the same
# `core/camera.lane_order` tensor every time
_CHECKED_PERMS: dict = {}


def check_perm(what: str, perm, n: int, device) -> None:
    """Raise unless `perm` is None or a contiguous int32 [n] tensor on
    `device` holding each of 0 .. n - 1 once."""
    if perm is None:
        return
    kernel_lib.require(what, device, perm=(perm, torch.int32, (n,)))
    seen = _CHECKED_PERMS.get(id(perm))
    if seen is not None and seen[0]() is perm and seen[1] == perm._version:
        return
    if not torch.equal(torch.sort(perm).values,
                       torch.arange(n, dtype=torch.int32, device=perm.device)):
        raise ValueError(f"{what}: perm is not a permutation of 0 .. {n - 1}")
    for key in [k for k, (ref, _) in _CHECKED_PERMS.items() if ref() is None]:
        del _CHECKED_PERMS[key]
    _CHECKED_PERMS[id(perm)] = (weakref.ref(perm), perm._version)


def _has_tables(what, scene) -> None:
    if scene.wide_records is None:
        raise ValueError(f"{what}: the scene has no wide tables (walk {scene.walk!r})")


def _tables(what, scene, device) -> list:
    kernel_lib.require(
        what, device, wide_records=(scene.wide_records, torch.int32, None),
        wide_roots=(scene.wide_roots, torch.int32, None),
        tris4=(scene.tris4, torch.float32, None), shade=(scene.shade, torch.float32, None),
    )
    kernel_lib.require_aligned(what, wide_records=scene.wide_records, tris4=scene.tris4)
    return [scene.wide_records.data_ptr(), scene.wide_roots.data_ptr(), scene.wide_roots.numel(),
            scene.tris4.data_ptr()]


def closest_hit_wide(scene, o, d, t0, mask=None, perm=None) -> dict:
    """Closest hit by the wide walk: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors, its lanes taking the rays in the order
    `perm` int32 [R] where given (outputs in ray order either way)."""
    _has_tables("closest_hit_wide", scene)
    check_perm("closest_hit_wide", perm, o.shape[0], o.device)
    if kernel_lib.on_cpu("closest_hit_wide", o):
        return closest_hit_wide_plain(scene, o, d, t0, mask)
    out = launch_closest("closest_hit_wide", "crt_closest_hit_wide", o, d, t0, mask,
                         [*_tables("closest_hit_wide", scene, o.device),
                          *id_tables("closest_hit_wide", scene, o.device),
                          int(scene.leaf_codes), kernel_lib.ptr(perm)])
    closest_hit_wide.launches += 1
    return out


def occluded_wide(scene, o, d, t0, mask=None, perm=None) -> torch.Tensor:
    """Any hit by the wide walk: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors, in the lane order `perm` where given."""
    _has_tables("occluded_wide", scene)
    check_perm("occluded_wide", perm, o.shape[0], o.device)
    if kernel_lib.on_cpu("occluded_wide", o):
        return occluded_wide_plain(scene, o, d, t0, mask)
    out = launch_occluded("occluded_wide", "crt_occluded_wide", o, d, t0, mask,
                          [*_tables("occluded_wide", scene, o.device), int(scene.leaf_codes),
                           kernel_lib.ptr(perm)])
    occluded_wide.launches += 1
    return out


closest_hit_wide.launches = 0  # kernel launches since the last reset
occluded_wide.launches = 0
