"""The per-ray surface prologue that the wavefront path tracer and the
Whitted level kernels share (`csrc/surface.cuh`), in plain PyTorch, and the
packed scene parameters both kernels read.

Every formula is the kernel's, component by component and in its float32
operation order, so that on the card a kernel and its plain version agree
bit for bit; on the CPU the plain versions are what the wrappers run.
"""

from __future__ import annotations

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch import constants
from cpu_ray_tracer_tpu_torch.ops import closest_hit, intersect, link_walk
from cpu_ray_tracer_tpu_torch.ops.closest_hit import closest_hit_plain, occluded_plain
from cpu_ray_tracer_tpu_torch.ops.link_walk import closest_hit_links_plain, occluded_links_plain

EPS = constants.SHADE_EPS
INV2PI_W = np.float32(constants.INVPI * 2.0 * np.pi)  # diffuse estimator weight
MAX_MATS = 64  # csrc/surface.cuh MAX_MATS
_F32 = torch.float32


def kernel_params(scene) -> torch.Tensor:
    """Scene scalars and the material table as one float32 array in the
    layout of `csrc/surface.cuh` (P_* and MAT_F there); integer fields are
    bit-cast.  Texture offsets are plain int32 (the TPU kernel's hi/lo f32
    split is a Mosaic workaround).  `DeviceScene` packs it once, as its
    `kernel_params` buffer."""
    dev = scene.device

    def bits(x):
        return x.to(torch.int32).view(_F32)[:, None]

    head = torch.cat([
        scene.light_inv_t.reshape(16),
        -scene.light_t[:3, 1],
        scene.light_size.reshape(1),
        scene.floor_inv_to.reshape(1),
        intersect.light_pos(scene.light_t),
        torch.tensor([INV2PI_W, constants.TWO_PI], dtype=_F32, device=dev),
    ])
    mats = torch.cat([
        scene.mat_albedo, scene.mat_reflectivity[:, None], scene.mat_refractivity[:, None],
        scene.mat_absorption, bits(scene.mat_is_light), bits(scene.mat_tex_id),
        bits(scene.mat_tex_off), bits(scene.mat_tex_w), bits(scene.mat_tex_h),
    ], dim=1)
    return torch.cat([head, mats.reshape(-1)]).contiguous()


def params(scene) -> torch.Tensor:
    """The scene's packed `kernel_params`, for a kernel launch."""
    if scene.material_count > MAX_MATS:
        raise ValueError(f"{scene.material_count} materials, the kernels take {MAX_MATS}")
    return scene.kernel_params


def walk_tables(what, scene, device) -> list:
    """Check the fused kernels' walk tables on `device`; returns their
    launch arguments: the records, the node count, the root, whether the
    walk is the link walk (`DeviceScene.stack_walk` false), the leaf code
    form (`DeviceScene.leaf_codes`), and `tris4`.
    Raises for a scene whose ids do not fit the meta word, which the
    kernels read the hit's material from."""
    if scene.slot_ids is not None:
        raise ValueError(f"{what}: the scene's hit ids do not fit the meta word the fused "
                         "kernels read materials from (DeviceScene.stack_kernels)")
    m, codes = scene.nodes.shape[0], int(scene.leaf_codes)
    if scene.stack_walk:
        records, tris4, root = closest_hit.stack_tables(what, scene, device)
        return [records, m, root, 0, codes, tris4]
    records, m, tris4 = link_walk.link_tables(what, scene, device)
    return [records, m, scene.root, 1, codes, tris4]


def walk_plain(scene, o, d, t0, mask=None, any_hit: bool = False):
    """The plain version of the walk the kernels take on `scene`: the
    binary stack walk, or the link walk where the stack walk does not
    serve the tree (`DeviceScene.stack_walk`).  The closest hit's dict, or
    with `any_hit` the occlusion bool [R]."""
    if scene.stack_walk:
        return (occluded_plain if any_hit else closest_hit_plain)(scene, o, d, t0, mask)
    return (occluded_links_plain if any_hit else closest_hit_links_plain)(scene, o, d, t0, mask)


def nearest_surface(scene, o, d, walk=None) -> dict:
    """`nearest_surface` of csrc/surface.cuh: light quad -> floor -> BVH walk
    (rays with `walk` [R] False skip the walk), hit info with the back-face
    flip.  Returns t, obj (0 light, 1 floor, 2 triangle, -1 miss), slot,
    point p [R, 3] and normal n [R, 3] as xyz triples of [R] tensors, u, v,
    mat, traversed, tested."""
    t, obj = intersect.primitive_hits(scene, o, d)
    hit = walk_plain(scene, o, d, t, walk)
    t = hit["t"]
    tri = hit["slot"] >= 0
    obj = torch.where(tri, 2, obj)
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    p = (ox + t * dx, oy + t * dy, oz + t * dz)

    u, v = hit["u"], hit["v"]
    rec = scene.shade[hit["slot"].clamp_min(0).long()]
    w = 1.0 - u - v

    def lerp(k):
        return w * rec[:, k] + u * rec[:, k + 3] + v * rec[:, k + 6]

    tn = (lerp(0), lerp(1), lerp(2))
    rn = torch.rsqrt(torch.clamp_min(tn[0] * tn[0] + tn[1] * tn[1] + tn[2] * tn[2], 1e-20))
    light_n = -scene.light_t[:3, 1]
    is_light, is_floor = obj == 0, obj == 1
    n = tuple(
        torch.where(tri, tn[k] * rn, torch.where(is_light, light_n[k], np.float32(floor)))
        for k, floor in enumerate((0.0, 1.0, 0.0))
    )
    fito = scene.floor_inv_to
    fu, fv = p[0] * fito, p[2] * fito
    tu = w * rec[:, 9] + u * rec[:, 11] + v * rec[:, 13]
    tv = w * rec[:, 10] + u * rec[:, 12] + v * rec[:, 14]
    zero = np.float32(0.0)
    su = torch.where(tri, tu, torch.where(is_floor, fu - torch.floor(fu), zero))
    sv = torch.where(tri, tv, torch.where(is_floor, fv - torch.floor(fv), zero))
    mat = torch.where(
        tri, hit["mat_id"],
        torch.where(is_light, 0, torch.where(is_floor, 1, scene.material_count - 1)),
    ).to(torch.int32)
    flip = n[0] * dx + n[1] * dy + n[2] * dz > 0.0
    n = tuple(torch.where(flip, -c, c) for c in n)
    return dict(
        t=t, obj=obj, slot=hit["slot"], p=p, n=n, u=su, v=sv, mat=mat,
        traversed=hit["traversed"], tested=hit["tested"],
    )


def texel_index(scene, mat, u, v) -> torch.Tensor:
    """Nearest-texel index of a textured material (texture.h:61-96
    truncation), -1 where the material has no texture: int32 [R]."""
    m = mat.long()
    off, w, h = scene.mat_tex_off[m], scene.mat_tex_w[m], scene.mat_tex_h[m]
    uu = torch.clamp(u, 0.0, 1.0)
    vv = 1.0 - torch.clamp(v, 0.0, 1.0)
    tx = torch.minimum(torch.clamp_min((uu * w.to(_F32)).to(torch.int32), 0), w - 1)
    ty = torch.minimum(torch.clamp_min((vv * h.to(_F32)).to(torch.int32), 0), h - 1)
    return torch.where(scene.mat_tex_id[m] >= 0, off + tx + ty * w, -1).to(torch.int32)


def dielectric(d, n, inside) -> dict:
    """`dielectric` of csrc/surface.cuh (the TPU kernel's operation order,
    wavefront_pt.py:331-351): fr, can, transmitted t [xyz], reflected r
    [xyz]."""
    dx, dy, dz = d.unbind(1)
    nx, ny, nz = n
    one = np.float32(1.0)
    n1 = torch.where(inside, constants.IOR, one)
    n2 = torch.where(inside, one, constants.IOR)
    eta = n1 / n2
    ddn = dx * nx + dy * ny + dz * nz
    cosi = -ddn
    cost2 = 1.0 - eta * eta * (1.0 - cosi * cosi)
    can = cost2 > 0.0
    tscale = eta * cosi - torch.sqrt(cost2.abs())
    a, b = n1 - n2, n1 + n2
    r0 = (a * a) / (b * b)
    c = 1.0 - cosi
    fr = torch.where(can, r0 + (1.0 - r0) * c * c * c * c * c, one)
    return dict(
        fr=fr, can=can,
        t=(eta * dx + tscale * nx, eta * dy + tscale * ny, eta * dz + tscale * nz),
        r=(dx - 2.0 * nx * ddn, dy - 2.0 * ny * ddn, dz - 2.0 * nz * ddn),
    )
