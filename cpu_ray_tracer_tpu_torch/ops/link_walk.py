"""Closest-hit and any-hit queries over a tree threaded with per-octant hit
and miss links (the grid and KD cell forests, `accel/cell_tree.py`): the
CUDA kernels' wrappers (`closest_hit_links`, `occluded_links`) and their
plain PyTorch versions (`closest_hit_links_plain`, `occluded_links_plain`).

The port of the JAX package's threaded link walk `_kernel`
(cpu_ray_tracer_tpu/ops/pallas/packet_bvh.py:133, launched at :749-760).
There a 4096-ray tile follows one cursor with the tile's majority octant;
here each ray walks alone, with its own octant (`csrc/ptraverse.cuh`
`walk_links`): from the first root, slab-test the node against the ray's
current t; a hit leaf's triangles are tested in slot order; then the
cursor takes the node's hit link where an interior node was hit and its
miss link otherwise, until -1.  The walk needs no stack, so a deep KD
forest costs nothing extra.  `traversed` counts every node visited,
`tested` the triangle tests.  The any-hit mode stops at the first
accepted triangle.

Same arguments and outputs as `ops/closest_hit.py`.  Each wrapper runs the
plain version for tensors on the CPU and launches the kernel for tensors
on a CUDA device; there is no other fallback.
"""

from __future__ import annotations

import torch

from cpu_ray_tracer_tpu_torch.accel.pack import N_COUNT, N_FIRST
from cpu_ray_tracer_tpu_torch.ops import kernel_lib
from cpu_ray_tracer_tpu_torch.ops.closest_hit import (
    decode, id_tables, launch_closest, launch_occluded, leaf_tests, octants, outputs, slab,
)


def _walk_plain(scene, o, d, t0, mask, any_hit: bool) -> dict:
    """The kernel's walk in plain PyTorch, lockstep over the rays: each
    round every unfinished ray visits one node of its own walk.  With
    `any_hit` a ray stops after the node at which it accepted a triangle
    (the kernel stops at that triangle; the boolean is the same)."""
    nodes, links, tris = scene.nodes, scene.links, scene.tris
    res = outputs(t0)
    r, dev = o.shape[0], o.device
    live = torch.ones(r, dtype=torch.bool, device=dev) if mask is None else mask.bool()
    rd = 1.0 / d
    link_col = 2 * octants(d)
    fnodes = nodes.view(torch.float32)
    cur = torch.where(live, scene.root, -1).long()
    while True:
        ids = torch.nonzero(cur >= 0).squeeze(1)
        if ids.numel() == 0:
            break
        c = cur[ids]
        hit = slab(fnodes[c, 0:6], o[ids], rd[ids], res["t"][ids])
        count = nodes[c, N_COUNT]
        leaf = hit & (count > 0)
        leaf_tests(tris, ids[leaf], nodes[c[leaf], N_FIRST], count[leaf], o, d, res)
        descend = hit & (count == 0)
        nxt = links[c, link_col[ids] + torch.where(descend, 0, 1)].long()
        if any_hit:
            nxt = torch.where(res["slot"][ids] >= 0, -1, nxt)
        cur[ids] = nxt
        res["traversed"][ids] += 1
    return res


def closest_hit_links_plain(scene, o, d, t0, mask=None) -> dict:
    """The kernel's closest-hit walk in plain PyTorch, lockstep over the
    rays, so t/u/v, ids and counters equal the kernel's."""
    return decode(scene, _walk_plain(scene, o, d, t0, mask, any_hit=False))


def occluded_links_plain(scene, o, d, t0, mask=None) -> torch.Tensor:
    """Bool [R]: whether a triangle hit exists in (TRI_EPS, t0), by the
    any-hit link walk in plain PyTorch."""
    return _walk_plain(scene, o, d, t0, mask, any_hit=True)["slot"] >= 0


def _has_tables(what, scene) -> None:
    if scene.links is None:
        raise ValueError(f"{what}: the scene has no link table (walk {scene.walk!r})")


def link_tables(what, scene, device) -> list:
    """Check the link walk's tables on `device`; returns the launch
    arguments `link_records`, the node count and `tris4`.  The wavefront
    and Whitted kernels take them too, on a BVH too deep for the stack
    walk."""
    _has_tables(what, scene)
    m = scene.nodes.shape[0]
    kernel_lib.require(
        what, device, link_records=(scene.link_records, torch.int32, (8, m, 8)),
        tris4=(scene.tris4, torch.float32, None), shade=(scene.shade, torch.float32, None),
    )
    kernel_lib.require_aligned(what, link_records=scene.link_records, tris4=scene.tris4)
    return [scene.link_records.data_ptr(), m, scene.tris4.data_ptr()]


def closest_hit_links(scene, o, d, t0, mask=None) -> dict:
    """Closest hit by the link walk: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    _has_tables("closest_hit_links", scene)
    if kernel_lib.on_cpu("closest_hit_links", o):
        return closest_hit_links_plain(scene, o, d, t0, mask)
    tables = link_tables("closest_hit_links", scene, o.device)
    out = launch_closest("closest_hit_links", "crt_closest_hit_links", o, d, t0, mask,
                         [*tables, *id_tables("closest_hit_links", scene, o.device), scene.root,
                          int(scene.leaf_codes)])
    closest_hit_links.launches += 1
    return out


def occluded_links(scene, o, d, t0, mask=None) -> torch.Tensor:
    """Any hit by the link walk: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    _has_tables("occluded_links", scene)
    if kernel_lib.on_cpu("occluded_links", o):
        return occluded_links_plain(scene, o, d, t0, mask)
    tables = link_tables("occluded_links", scene, o.device)
    out = launch_occluded("occluded_links", "crt_occluded_links", o, d, t0, mask,
                          [*tables, scene.root, int(scene.leaf_codes)])
    occluded_links.launches += 1
    return out


closest_hit_links.launches = 0  # kernel launches since the last reset
occluded_links.launches = 0
