"""Scene queries over ray batches, as the JAX package's
`cpu_ray_tracer_tpu/scene/query.py:142-185, 265-470` for the TLAS-baked
BVH scene: FindNearest, IsOccluded, GetHitInfo, the material fields,
GetAlbedo, the sky and GetLightPos (the reference's BaseScene virtuals,
infra/scene/base_scene.h:16-32).
"""

from __future__ import annotations

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch import constants
from cpu_ray_tracer_tpu_torch.core import textures as tex_mod
from cpu_ray_tracer_tpu_torch.ops import intersect
from cpu_ray_tracer_tpu_torch.ops.closest_hit import closest_hit, occluded

def find_nearest(scene, o: torch.Tensor, d: torch.Tensor) -> dict:
    """Nearest hit over light quad -> floor plane -> triangle BVH, as
    FileScene::FindNearest (file_scene.cpp:170-175).  Object ids: 0 light,
    1 floor, >= 2 mesh instances, -1 miss."""
    t, obj = intersect.primitive_hits(scene, o, d)
    res = closest_hit(scene, o, d, t)
    tri_hit = res["tri_idx"] >= 0
    return dict(
        t=res["t"],
        obj_idx=torch.where(tri_hit, res["obj_id"], obj),
        tri_idx=res["tri_idx"],
        slot=res["slot"],
        u=res["u"],
        v=res["v"],
        mat_id_tri=res["mat_id"],
        traversed=res["traversed"],
        tested=res["tested"],
    )


def is_occluded(scene, o: torch.Tensor, d: torch.Tensor, dist: torch.Tensor, mask=None):
    """Shadow query (file_scene.cpp:177-187): the light quad occludes within
    `dist` (the caller passes dist - 2 EPS); triangles occlude within
    RAY_FAR when `scene.shadow_quirk` (the reference's quirk), else within
    `dist`.  The floor never occludes.  `mask` [R] bool limits the triangle
    query; bool [R]."""
    _, lhit = intersect.quad(o, d, scene.light_inv_t, scene.light_size, dist)
    tri_t = torch.full_like(dist, constants.RAY_FAR) if scene.shadow_quirk else dist
    return lhit | occluded(scene, o, d, tri_t.contiguous(), mask)


def get_light_pos(scene) -> torch.Tensor:
    """GetLightPos: the point light, float32 [3] (`intersect.light_pos`)."""
    return intersect.light_pos(scene.light_t)


def get_hit_info(scene, hit: dict, point: torch.Tensor, d: torch.Tensor):
    """Normal, uv and material id per ray (tlas_file_scene.cpp:220-260),
    with the back-face flip `if dot(N, D) > 0: N = -N`.  Triangle hits
    interpolate the winning slot's shading record."""
    obj = hit["obj_idx"]
    tri_hit = (hit["tri_idx"] >= 0)[:, None]
    rec = scene.shade[hit["slot"].clamp_min(0).long()]
    bu = hit["u"][:, None]
    bv = hit["v"][:, None]
    w = (1.0 - hit["u"] - hit["v"])[:, None]
    n_tri = w * rec[:, 0:3] + bu * rec[:, 3:6] + bv * rec[:, 6:9]
    uv_tri = w * rec[:, 9:11] + bu * rec[:, 11:13] + bv * rec[:, 13:15]
    sq = (n_tri * n_tri).sum(dim=-1, keepdim=True)
    n_tri = n_tri * torch.rsqrt(torch.clamp_min(sq, np.float32(1e-20)))

    # light quad normal: TransformVector((0,-1,0), T) (primitives.h:365-369)
    light_n = -scene.light_t[:3, 1]
    floor_n = torch.as_tensor(intersect.FLOOR_NORMAL, device=point.device)
    floor_uv = intersect.plane_uv(point, scene.floor_inv_to)
    is_light = (obj == 0)[:, None]
    is_floor = (obj == 1)[:, None]
    normal = torch.where(tri_hit, n_tri, torch.where(is_light, light_n, floor_n))
    uv = torch.where(tri_hit, uv_tri, torch.where(is_floor, floor_uv, 0.0))
    mat_id = torch.where(tri_hit[:, 0], hit["mat_id_tri"], torch.where(is_light[:, 0], 0, 1))
    # error material (pink) for misses queried anyway
    mat_id = torch.where(obj < 0, scene.material_count - 1, mat_id)
    flip = ((normal * d).sum(dim=-1) > 0)[:, None]
    return torch.where(flip, -normal, normal), uv, mat_id


def material_fields(scene, mat_id: torch.Tensor) -> dict:
    """Per-ray material scalars: a plain index of the material table (the
    JAX package does this with a one-hot matrix product, exact as well)."""
    m = mat_id.long()
    return dict(
        albedo=scene.mat_albedo[m],
        reflectivity=scene.mat_reflectivity[m],
        refractivity=scene.mat_refractivity[m],
        absorption=scene.mat_absorption[m],
        is_light=scene.mat_is_light[m],
        tex_id=scene.mat_tex_id[m],
        tex_off=scene.mat_tex_off[m],
        tex_w=scene.mat_tex_w[m],
        tex_h=scene.mat_tex_h[m],
    )


def get_albedo(scene, fields: dict, uv: torch.Tensor) -> torch.Tensor:
    """Material::GetAlbedo (material.h:28-35): the nearest texel where the
    material has a texture, the constant albedo otherwise."""
    texel = tex_mod.nearest_texel(
        scene.atlas_packed, fields["tex_off"], fields["tex_w"], fields["tex_h"],
        uv[:, 0], uv[:, 1],
    )
    return torch.where((fields["tex_id"] >= 0)[:, None], texel, fields["albedo"])


def texel_factor(scene, idx: torch.Tensor) -> torch.Tensor:
    """float32 [R, 3]: the atlas texel `idx` [R] (a nearest-texel index the
    wavefront and Whitted kernels record), 1 where idx < 0 (the JAX
    package's `_tex_rgb`, render/pathtracer.py:547)."""
    rgb = tex_mod.unpack_rgb(scene.atlas_packed[idx.clamp_min(0).long()])
    return torch.where((idx >= 0)[:, None], rgb, np.float32(1.0))


def sky_color(scene, d: torch.Tensor) -> torch.Tensor:
    """Equirect skydome sample, or black when the scene has none."""
    if scene.skydome_tex < 0:
        return torch.zeros(d.shape[:-1] + (3,), dtype=torch.float32, device=d.device)
    return tex_mod.sample_equirect(scene, d)
