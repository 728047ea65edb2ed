"""One Whitted level with its shadow rays: the CUDA kernel's wrapper
(`trace_level0`) and its plain PyTorch version (`trace_level0_plain`).

The port of the JAX package's fused Whitted level kernel
(cpu_ray_tracer_tpu/ops/pallas/whitted_wf.py: `_kernel` :70,
`trace_level0` :346); the per-ray math is described in
`csrc/whitted_wf.cu`.  Both take (scene, o, d, inside=None, alive=None,
perm=None) — rays (o, d) [R, 3], optional inside / alive [R] bool, and an
optional lane order `perm` int32 [R] (lane j of the kernel takes ray
perm[j]: `core/camera.lane_order` for camera rays), which moves only which
rays share a warp — and return, per ray in the input order:

    t                     float32 [R]  hit distance (RAY_FAR on a miss)
    miss, lit, surf, vis, emit1, emit2   bool [R]  (the F_* flag bits)
    mat, tex_idx          int32 [R]    material id; nearest-texel index of
                                       a textured surface, else -1
    irr_scale             float32 [R]  N.L / dist^2 where the point light
                                       is visible from a diffuse surface
    r_dir, t_dir          float32 [R, 3]  reflected and transmitted directions
    fr                    float32 [R]  Schlick Fresnel (1 under total
                                       internal reflection)
    traversed, tested     int32 [R]    the nearest-hit walk's counters

Dead rays skip both walks and report no hit.  `trace_level0` runs the
plain version for tensors on the CPU and launches the kernel for tensors
on a CUDA device; there is no other fallback.  On a BVH too deep for the
stack walk both walk the link tables (`DeviceScene.stack_walk`).
"""

from __future__ import annotations

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch import constants
from cpu_ray_tracer_tpu_torch.ops import intersect, kernel_lib, surface

F_MISS, F_LIT, F_SURF, F_VIS, F_EMIT1, F_EMIT2 = 1, 2, 4, 8, 16, 32  # whitted_wf.py:62-67
_FLAGS = dict(miss=F_MISS, lit=F_LIT, surf=F_SURF, vis=F_VIS, emit1=F_EMIT1, emit2=F_EMIT2)
_F32 = torch.float32
EPS = constants.SHADE_EPS


def trace_level0_plain(scene, o, d, inside=None, alive=None, perm=None) -> dict:
    """The kernel's per-ray math in plain PyTorch, over all rays at once
    (`perm` changes nothing here: each ray's outputs are its own)."""
    r, dev = o.shape[0], o.device
    live = torch.ones(r, dtype=torch.bool, device=dev) if alive is None else alive
    ins = torch.zeros(r, dtype=torch.bool, device=dev) if inside is None else inside
    sf = surface.nearest_surface(scene, o, d, live)
    hit = live & (sf["obj"] >= 0)
    miss = live & (sf["obj"] < 0)
    m = sf["mat"].long()
    refl, refr = scene.mat_reflectivity[m], scene.mat_refractivity[m]
    is_light = hit & scene.mat_is_light[m]
    surf = hit & ~is_light
    tex = torch.where(surf, surface.texel_index(scene, sf["mat"], sf["u"], sf["v"]), -1)

    # diffuse: point-light shadow ray
    do_diffuse = surf & (1.0 - (refl + refr) > 0.0)
    lp = intersect.light_pos(scene.light_t)
    px, py, pz = sf["p"]
    lx, ly, lz = lp[0] - px, lp[1] - py, lp[2] - pz
    dist = torch.sqrt(lx * lx + ly * ly + lz * lz)
    inv_d = 1.0 / torch.clamp_min(dist, np.float32(1e-20))
    ld = torch.stack([lx * inv_d, ly * inv_d, lz * inv_d], dim=1)
    nx, ny, nz = sf["n"]
    ndotl = nx * ld[:, 0] + ny * ld[:, 1] + nz * ld[:, 2]
    so = torch.stack(sf["p"], dim=1) + ld * EPS
    dmax = torch.clamp_min(dist - np.float32(2.0) * EPS, np.float32(1e-6))
    _, occ_q = intersect.quad(so, ld, scene.light_inv_t, scene.light_size, dmax)
    walk = do_diffuse & (ndotl >= EPS) & ~occ_q
    t0 = torch.full_like(dmax, constants.RAY_FAR) if scene.shadow_quirk else dmax
    vis = walk & ~surface.walk_plain(scene, so, ld, t0, walk, any_hit=True)
    att = 1.0 / torch.clamp_min(dist * dist, np.float32(1e-20))
    irr = torch.where(vis, att * ndotl, np.float32(0.0))

    dl = surface.dielectric(d, sf["n"], ins)
    is_mirror = surf & (refl > 0.0)
    is_diel = surf & ~(refl > 0.0) & (refr > 0.0)
    return dict(
        t=sf["t"], miss=miss, lit=is_light, surf=surf, vis=vis,
        emit1=is_mirror | is_diel, emit2=is_diel & dl["can"],
        mat=sf["mat"], tex_idx=tex.to(torch.int32), irr_scale=irr,
        r_dir=torch.stack(dl["r"], dim=1), t_dir=torch.stack(dl["t"], dim=1), fr=dl["fr"],
        traversed=sf["traversed"], tested=sf["tested"],
    )


def trace_level0(scene, o, d, inside=None, alive=None, perm=None) -> dict:
    """One Whitted level of rays (o, d): the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (module docstring)."""
    if kernel_lib.on_cpu("whitted_wf.trace_level0", o):
        return trace_level0_plain(scene, o, d, inside, alive)
    r, dev = o.shape[0], o.device
    kernel_lib.require(
        "whitted_wf.trace_level0", dev,
        o=(o, _F32, (r, 3)), d=(d, _F32, (r, 3)),
        inside=(inside, torch.bool, (r,)), alive=(alive, torch.bool, (r,)),
        perm=(perm, torch.int32, (r,)),
    )
    walk = surface.walk_tables("whitted_wf.trace_level0", scene, dev)
    params = surface.params(scene)
    k = kernel_lib.load()
    f32 = dict(dtype=_F32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = dict(
        t=torch.empty(r, **f32), flags=torch.empty(r, **i32), mat=torch.empty(r, **i32),
        tex_idx=torch.empty(r, **i32), irr_scale=torch.empty(r, **f32),
        r_dir=torch.empty((r, 3), **f32), t_dir=torch.empty((r, 3), **f32),
        fr=torch.empty(r, **f32), traversed=torch.empty(r, **i32), tested=torch.empty(r, **i32),
    )
    code = k.lib.crt_whitted_wf(
        o.data_ptr(), d.data_ptr(), kernel_lib.ptr(alive), kernel_lib.ptr(inside), r, *walk,
        scene.shade.data_ptr(), params.data_ptr(), scene.material_count,
        int(scene.shadow_quirk), kernel_lib.ptr(perm),
        *(out[key].data_ptr() for key in (
            "t", "flags", "mat", "tex_idx", "irr_scale", "r_dir", "t_dir", "fr",
            "traversed", "tested",
        )),
        kernel_lib.stream(dev),
    )
    kernel_lib.check(k.lib, code, "whitted_wf")
    trace_level0.launches += 1
    flags = out.pop("flags")
    out.update({name: (flags & bit) != 0 for name, bit in _FLAGS.items()})
    return out


trace_level0.launches = 0  # kernel launches since the last reset
