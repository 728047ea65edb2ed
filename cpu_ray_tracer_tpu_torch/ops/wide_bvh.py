"""Closest-hit and any-hit queries over the wide (8-ary) BVH
(`accel/wide.py`): the CUDA kernels' wrappers (`closest_hit_wide`,
`occluded_wide`) and their plain PyTorch versions (`closest_hit_wide_plain`,
`occluded_wide_plain`).

The port of the JAX package's wide walk `_kernel`
(cpu_ray_tracer_tpu/ops/pallas/wide_bvh.py:54, launched at :292-335).
There a 4096-ray tile pops one wide node per step under the tile's
majority octant; here each ray walks alone, with its own octant
(`csrc/ptraverse.cuh` `walk_wide`).  A step pops one wide node, slab-tests
its 8 child boxes against the ray's current t, tests the triangles of each
hit leaf child in slot order (child 0 first), and goes on to the nearest
hit interior child under the node's order word for the ray's octant.  The
other hit interior children stay behind as one stack word
`node << 8 | pending-child mask` (the JAX kernel's word, wide_bvh.py:
202-251), from which a later pop takes the nearest; a pending word with
mask 0 is a forest root.  So the stack holds at most one word per level,
and `accel/wide.py` asserts its capacity at pack time.  `traversed`
counts wide-node steps, `tested` the triangle tests; the any-hit mode
stops at the first accepted triangle.

Same arguments and outputs as `ops/closest_hit.py`; the slots are the
binary pack's.  Each wrapper runs the plain version for tensors on the CPU
and launches the kernel for tensors on a CUDA device; there is no other
fallback.
"""

from __future__ import annotations

import torch

from cpu_ray_tracer_tpu_torch.accel.pack import LEAF_SHIFT
from cpu_ray_tracer_tpu_torch.accel.wide import W_CHILD, W_ORDER, WIDE, WIDE_STACK_CAP
from cpu_ray_tracer_tpu_torch.ops import kernel_lib
from cpu_ray_tracer_tpu_torch.ops.closest_hit import (
    decode, id_tables, launch_closest, launch_occluded, leaf_tests, octants, outputs, slab,
)


def _bit(s: torch.Tensor) -> torch.Tensor:
    """1 << s, elementwise."""
    return torch.ones_like(s) << s


def _nearest(bits: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """The child slot of `bits` [n] of lowest rank in order words `order`
    [n] (rank r at bits 3r .. 3r + 2), -1 where `bits` is 0."""
    sel = torch.full_like(bits, -1)
    for rank in range(WIDE):
        s = (order >> (3 * rank)) & 7
        sel = torch.where((sel < 0) & (((bits >> s) & 1) > 0), s, sel)
    return sel


def leaf_fields(scene, code: torch.Tensor):
    """(first slot, triangle count) of leaf codes (accel/pack.py): count <<
    LEAF_SHIFT | first where the scene's leaves fit, else the first slot,
    whose `tris4` word 3 counts the leaf's slots."""
    if scene.leaf_codes:
        return code & ((1 << LEAF_SHIFT) - 1), (code >> LEAF_SHIFT).to(torch.int32)
    return code, scene.tris4.view(torch.int32)[code.long(), 3]


def _walk_plain(scene, o, d, t0, mask, any_hit: bool) -> dict:
    """The kernel's walk in plain PyTorch, lockstep over the rays: each
    round every unfinished ray takes one step of its own walk.  With
    `any_hit` a ray stops after the step in which it accepted a triangle
    (the kernel stops at that triangle; the boolean is the same)."""
    wide, tris = scene.wide_nodes.long(), scene.tris
    r, dev = o.shape[0], o.device
    res = outputs(t0)
    live = torch.ones(r, dtype=torch.bool, device=dev) if mask is None else mask.bool()
    rd = 1.0 / d
    order_col = W_ORDER + octants(d)
    boxes = scene.wide_nodes[:, : 6 * WIDE].view(torch.float32).reshape(-1, WIDE, 6)
    roots = scene.wide_roots.long()
    # forest roots after the first wait on the stack as mask-0 words
    stack = torch.zeros((r, WIDE_STACK_CAP), dtype=torch.long, device=dev)
    stack[:, : roots.numel() - 1] = roots[1:].flip(0) << 8
    sp = torch.full((r,), roots.numel() - 1, dtype=torch.long, device=dev)
    cur = torch.where(live, roots[0], -1)
    while True:
        ids = torch.nonzero(cur >= 0).squeeze(1)
        if ids.numel() == 0:
            break
        n = ids.numel()
        c = cur[ids]
        rec = wide[c]
        child = rec[:, W_CHILD : W_CHILD + WIDE]
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
        interior = hit & (child > 0)
        ibits = (interior.long() * _bit(torch.arange(WIDE, device=dev))).sum(1)
        sel = _nearest(ibits, rec.gather(1, order_col[ids, None])[:, 0])
        down = sel >= 0
        rest = ibits & ~_bit(sel.clamp_min(0))
        # pop: the top word's nearest pending child, or the root it names
        sp_i = sp[ids]
        top = stack[ids, (sp_i - 1).clamp_min(0)]
        p, pm = top >> 8, top & 0xFF
        prec = wide[p]
        selp = _nearest(pm, prec.gather(1, order_col[ids, None])[:, 0])
        pop_child = prec.gather(1, W_CHILD + selp.clamp_min(0)[:, None])[:, 0]
        pop_to = torch.where(pm == 0, p, pop_child)
        pm_rest = pm & ~_bit(selp.clamp_min(0))
        can_pop = ~down & (sp_i > 0)
        nxt = torch.where(
            down, child.gather(1, sel.clamp_min(0)[:, None])[:, 0],
            torch.where(can_pop, pop_to, -1),
        )
        push = down & (rest != 0)
        stack[ids[push], sp_i[push]] = (c[push] << 8) | rest[push]
        keep = can_pop & (pm_rest != 0)
        stack[ids[keep], sp_i[keep] - 1] = (p[keep] << 8) | pm_rest[keep]
        sp[ids] = sp_i + push.long() - (can_pop & ~keep).long()
        if any_hit:
            nxt = torch.where(res["slot"][ids] >= 0, -1, nxt)
        cur[ids] = nxt
        res["traversed"][ids] += 1
    return res


def closest_hit_wide_plain(scene, o, d, t0, mask=None) -> dict:
    """The kernel's closest-hit walk in plain PyTorch, lockstep over the
    rays, so t/u/v, ids and counters equal the kernel's."""
    return decode(scene, _walk_plain(scene, o, d, t0, mask, any_hit=False))


def occluded_wide_plain(scene, o, d, t0, mask=None) -> torch.Tensor:
    """Bool [R]: whether a triangle hit exists in (TRI_EPS, t0), by the
    any-hit wide walk in plain PyTorch."""
    return _walk_plain(scene, o, d, t0, mask, any_hit=True)["slot"] >= 0


def _has_tables(what, scene) -> None:
    if scene.wide_nodes is None:
        raise ValueError(f"{what}: the scene has no wide tables (walk {scene.walk!r})")


def _tables(what, scene, device) -> list:
    kernel_lib.require(
        what, device, wide_nodes=(scene.wide_nodes, torch.int32, None),
        wide_roots=(scene.wide_roots, torch.int32, None),
        tris4=(scene.tris4, torch.float32, None), shade=(scene.shade, torch.float32, None),
    )
    kernel_lib.require_aligned(what, tris4=scene.tris4)
    return [scene.wide_nodes.data_ptr(), scene.wide_roots.data_ptr(), scene.wide_roots.numel(),
            scene.tris4.data_ptr()]


def closest_hit_wide(scene, o, d, t0, mask=None) -> dict:
    """Closest hit by the wide walk: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    _has_tables("closest_hit_wide", scene)
    if kernel_lib.on_cpu("closest_hit_wide", o):
        return closest_hit_wide_plain(scene, o, d, t0, mask)
    tables = _tables("closest_hit_wide", scene, o.device)
    out = launch_closest("closest_hit_wide", "crt_closest_hit_wide", o, d, t0, mask,
                         [*tables, *id_tables("closest_hit_wide", scene, o.device),
                          int(scene.leaf_codes)])
    closest_hit_wide.launches += 1
    return out


def occluded_wide(scene, o, d, t0, mask=None) -> torch.Tensor:
    """Any hit by the wide walk: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    _has_tables("occluded_wide", scene)
    if kernel_lib.on_cpu("occluded_wide", o):
        return occluded_wide_plain(scene, o, d, t0, mask)
    tables = _tables("occluded_wide", scene, o.device)
    out = launch_occluded("occluded_wide", "crt_occluded_wide", o, d, t0, mask,
                          [*tables, int(scene.leaf_codes)])
    occluded_wide.launches += 1
    return out


closest_hit_wide.launches = 0  # kernel launches since the last reset
occluded_wide.launches = 0
