"""Whitted-style ray tracer: the JAX package's
`cpu_ray_tracer_tpu/render/whitted.py` (`_shade_level` :37,
`_shade_level_kernel` :141, `_compact_children` :210, `render` :287,
`render_adaptive` :432).

The reference's recursive `Trace` (2. WhittedStyle/renderer.cpp:21-126)
branches: a dielectric surface recurses into both the refracted (1 - Fr)
and the reflected (Fr) ray, a mirror into one ray, a diffuse surface into
none (its radiance is local: a shadow ray to the point light plus a
constant ambient).  Here it is a loop over levels: each level traces its
rays, adds their local radiance to their pixels weighted by the per-ray
throughput, and gathers up to two weighted children per ray into the next
level's rays.  Children are gathered exactly (`nonzero`), so none is ever
dropped: the JAX package's capacity pyramid and grow-or-fail loop exist for
XLA's static shapes.

A level runs through one of two routes, which give the same image up to
float32 rounding:
* `level_kernel=True` (the default on a binary BVH, as the JAX package on
  its chip): one launch of the Whitted level kernel (`ops/whitted_wf.py`)
  does the nearest hit, hit info and the shadow ray; the host gathers
  texels and the sky;
* `level_kernel=False`: the host queries of `scene/query` and
  `render/common` (the closest-hit and any-hit kernels of the scene's
  walk).

The level kernel walks the binary stack tables, so it serves only scenes
that have them (`DeviceScene.stack_kernels`, the JAX package's
`_use_kernel_level0`, render/whitted.py:125-138): `level_kernel=None`
takes it there and the host route elsewhere (grid, KD tree, a wide-only
BVH); an explicit `level_kernel=True` on such a scene raises.

The film adds later levels with `index_add_` at the children's pixels; on
the card that sum is atomic and its order varies from run to run.

`differentiable=True` (the JAX package's `_shade_level(differentiable=
True)`): every level takes the host route with `query.find_nearest_diff`
(detached walks, t and barycentrics recomputed with autograd) and
detached shadow queries, and the image carries gradients to the
parameters of `diff/grad.py`; an explicit `level_kernel=True` then
raises.  Nothing the film's `index_add_` reads is saved for the backward,
so it stays in place.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch import constants
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.ops import whitted_wf
from cpu_ray_tracer_tpu_torch.render import common
from cpu_ray_tracer_tpu_torch.scene import query

EPS = constants.SHADE_EPS


def level_kernel_for(scene, level_kernel, differentiable: bool = False) -> bool:
    """`level_kernel`, or for None the default of the scene (module
    docstring); False for a differentiable frame."""
    if differentiable:
        if level_kernel:
            raise ValueError("level_kernel=True with differentiable=True: gradients take the "
                             "host route")
        return False
    if level_kernel is None:
        return scene.stack_kernels
    if level_kernel and not scene.stack_kernels:
        raise ValueError(
            "level_kernel=True: the Whitted level kernel walks the binary stack tables, which "
            f"a scene walked by {scene.walk!r} does not serve")
    return bool(level_kernel)


def _level_host(scene, o, d, inside, perm=None, differentiable: bool = False) -> dict:
    """One level's hits, albedo, irradiance and dielectric terms through the
    host queries (`_shade_level`), the wide walk's lanes taking the rays
    in the order `perm` where given; with `differentiable`, t and the
    barycentrics carry gradients (`query.find_nearest_diff`)."""
    perm = query.wide_perm(scene, perm)
    nearest = query.find_nearest_diff if differentiable else query.find_nearest
    res = nearest(scene, o, d, perm)
    hit = res["obj_idx"] >= 0
    point = o + res["t"][:, None] * d
    normal, uv, mat_id = query.get_hit_info(scene, res, point, d)
    mf = query.material_fields(scene, mat_id)
    is_light = mf["is_light"] & hit
    surf = hit & ~is_light
    diffuse = surf & (1.0 - (mf["reflectivity"] + mf["refractivity"]) > 0.0)
    fr, can, t_dir, r_dir = common.dielectric_terms(d, normal, inside)
    is_diel = surf & ~(mf["reflectivity"] > 0.0) & (mf["refractivity"] > 0.0)
    return dict(
        t=res["t"], point=point, miss=~hit, lit=is_light, surf=surf, fields=mf,
        albedo=query.get_albedo(scene, mf, uv),
        irradiance=common.direct_illumination(scene, point, normal, active=diffuse, perm=perm),
        fr=fr, r_dir=r_dir, t_dir=t_dir, emit2=is_diel & can,
        traversed=res["traversed"], tested=res["tested"],
    )


def _level_kernel(scene, o, d, inside, perm=None) -> dict:
    """The same through one launch of the Whitted level kernel
    (`_shade_level_kernel`), its lanes taking the rays in the order
    `perm` where given."""
    wf = whitted_wf.trace_level0(scene, o, d, inside, perm=perm)
    mf = query.material_fields(scene, wf["mat"])
    texed = (wf["tex_idx"] >= 0)[:, None]
    return dict(
        t=wf["t"], point=o + wf["t"][:, None] * d, miss=wf["miss"], lit=wf["lit"],
        surf=wf["surf"], fields=mf,
        albedo=torch.where(texed, query.texel_factor(scene, wf["tex_idx"]), mf["albedo"]),
        irradiance=scene.light_color * wf["irr_scale"][:, None],
        fr=wf["fr"], r_dir=wf["r_dir"], t_dir=wf["t_dir"], emit2=wf["emit2"],
        traversed=wf["traversed"], tested=wf["tested"],
    )


def _shade(scene, lv: dict, d, inside, weight):
    """Local radiance [R, 3] of a level and its children's fields."""
    mf = lv["fields"]
    refl, refr = mf["reflectivity"], mf["refractivity"]
    diff = 1.0 - (refl + refr)
    medium = torch.where(
        inside[:, None], torch.exp(mf["absorption"] * (-lv["t"])[:, None]), np.float32(1.0)
    )
    albedo = lv["albedo"]
    contrib = torch.where(lv["miss"][:, None], weight, np.float32(0.0)) * query.sky_color(scene, d)
    contrib = torch.where(lv["lit"][:, None], weight * scene.light_color, contrib)
    ambient = torch.as_tensor(constants.AMBIENT, device=d.device)
    local = diff[:, None] * (albedo * constants.INVPI) * (lv["irradiance"] + ambient)
    diffuse = lv["surf"] & (diff > 0.0)
    contrib = torch.where(diffuse[:, None], contrib + weight * medium * local, contrib)

    # mirror (renderer.cpp:48-53) excludes the dielectric branch; fresh
    # reflected rays are outside (template/ray.h default, a reference quirk
    # kept); the refracted ray flips `inside`
    is_mirror = lv["surf"] & (refl > 0.0)
    is_diel = lv["surf"] & ~(refl > 0.0) & (refr > 0.0)
    fr = lv["fr"][:, None]
    children = dict(
        emit1=is_mirror | is_diel,
        o1=lv["point"] + lv["r_dir"] * EPS, d1=lv["r_dir"],
        w1=torch.where(
            is_mirror[:, None], weight * medium * refl[:, None] * albedo,
            weight * medium * albedo * fr,
        ),
        emit2=lv["emit2"],
        o2=lv["point"] + lv["t_dir"] * EPS, d2=lv["t_dir"],
        w2=weight * medium * albedo * (1.0 - fr),
    )
    return contrib, children


def radiance(scene, o, d, depth_limit: int = constants.DEPTH_LIMIT,
             level_kernel: bool | None = None, perm=None, differentiable: bool = False):
    """Whitted radiance [R, 3] along rays (o, d) [R, 3] (outside every
    medium), in the input order, and stats: the first level's per-ray
    `traversed` and `tested`, `rays` (rays traced over all levels, an int)
    and `levels` (levels traced).  The level kernel's lanes take the first
    level's rays in the order `perm` int32 [R] where given (a frame's
    `core/camera.lane_order`); later levels, which the children's gather
    builds, in their own order.  `differentiable`: module docstring."""
    if level_kernel_for(scene, level_kernel, differentiable):
        level = _level_kernel
    else:
        level = functools.partial(_level_host, differentiable=differentiable)
    n, dev = o.shape[0], o.device
    pixel = torch.arange(n, device=dev)
    inside = torch.zeros(n, dtype=torch.bool, device=dev)
    weight = torch.ones((n, 3), dtype=torch.float32, device=dev)
    film = None
    rays = 0
    for depth in range(depth_limit + 1):
        with torch.profiler.record_function(f"level_{depth}"):
            lv = level(scene, o, d, inside, perm if depth == 0 else None)
            contrib, ch = _shade(scene, lv, d, inside, weight)
            rays += o.shape[0]
            if film is None:
                film, stats = contrib, dict(traversed=lv["traversed"], tested=lv["tested"])
            else:
                film.index_add_(0, pixel, contrib)
            if depth == depth_limit:
                break
            i1 = torch.nonzero(ch["emit1"]).squeeze(1)
            i2 = torch.nonzero(ch["emit2"]).squeeze(1)
            if i1.numel() + i2.numel() == 0:
                break
            o = torch.cat([ch["o1"][i1], ch["o2"][i2]])
            d = torch.cat([ch["d1"][i1], ch["d2"][i2]])
            weight = torch.cat([ch["w1"][i1], ch["w2"][i2]])
            inside = torch.cat([torch.zeros_like(inside[i1]), ~inside[i2]])
            pixel = torch.cat([pixel[i1], pixel[i2]])
    return film, dict(stats, rays=rays, levels=depth + 1)


def render(scene, camera: cam_mod.Camera, depth_limit: int = constants.DEPTH_LIMIT,
           level_kernel: bool | None = None, differentiable: bool = False) -> dict:
    """One Whitted frame (unjittered primary rays) on the scene's device.
    Returns dict(image [H, W, 3], traversed and tested [H, W] of the
    primary rays, dropped (always 0: no child is ever dropped), rays,
    levels); with `differentiable` the image carries gradients to the
    scene's parameters (`diff/grad.apply_params`)."""
    o, d = cam_mod.full_frame_rays(camera, device=scene.device)
    film, stats = radiance(scene, o, d, depth_limit, level_kernel,
                           cam_mod.lane_order(camera, scene.device), differentiable)
    hw = (camera.height, camera.width)
    return dict(
        image=film.reshape(*hw, 3), traversed=stats["traversed"].reshape(hw),
        tested=stats["tested"].reshape(hw), dropped=0, rays=stats["rays"],
        levels=stats["levels"],
    )


def render_adaptive(scene, camera: cam_mod.Camera, depth_limit: int = constants.DEPTH_LIMIT,
                    cap_factor: float = 0.25, max_cap_factor: float = 8.0,
                    differentiable: bool = False, on_grow=None,
                    level_kernel: bool | None = None) -> dict:
    """The JAX package's grow-or-fail entry point.  Nothing is ever dropped
    here, so it renders once, never calls `on_grow`, and reports
    `cap_factor` as given."""
    out = render(scene, camera, depth_limit, level_kernel, differentiable)
    out["cap_factor"] = cap_factor
    return out
