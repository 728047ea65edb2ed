"""Monte-Carlo path tracer: the JAX package's host-bounce path
(`cpu_ray_tracer_tpu/render/pathtracer.py`: `_bounce_step` :315-470,
`sample_radiance` and `render_pass` :1189-1474, with `CRT_WAVEFRONT=0`)
and its wavefront configuration (`_sample_radiance_wavefront` :636-777,
`CRT_WAVEFRONT=1`, `CRT_WF_DEPTHS=k`).

The reference's recursive `Sample` (3. PathTracer/renderer.cpp:50-101) is a
loop over depths with one stochastic child per bounce.  Estimator:

* one uniform draw picks the lobe: r < refl -> mirror; r < refl + refr ->
  dielectric (stochastic Fresnel choice); else diffuse;
* diffuse: uniform-hemisphere direction, weight brdf * 2pi * cos;
* a miss records the sky BEFORE the depth check; a light hit ends the path;
* Beer absorption while inside; every new ray resets `inside` except the
  refracted one.

Emission is deferred: a path emits at most once (sky on a miss, light on a
light hit) and a finished ray's direction and throughput never change
again, so the state keeps two bits (`missed`, `lit`) and the emission is
applied after the last depth.

`wavefront_depths=k` runs depths [0, k) in one launch of the wavefront
kernel (`ops/wavefront_pt.py`), with the state in registers and the rays in
pixel order; its textured hits multiply albedo 1 and record texel indices,
whose factors multiply the radiance at the end (albedo only scales the
throughput).  The rays still alive go on through the host bounce from
depth k.  k = 0 is the host bounce alone.

The ray state of the host bounce stays in pixel order.  At each depth the
live rays are gathered, ordered by (direction octant, previous hit: the
triangle, or the slot where the wavefront kernel made the hit) — the
`locus` key of the JAX package's `_compaction_perm`, which only affects
speed — bounced, and scattered back.  This replaces the JAX package's
chunk scans, `lax.cond` skips and tier cascade, which exist for XLA's
static shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch import constants
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.core import rng
from cpu_ray_tracer_tpu_torch.core import vecmath as vm
from cpu_ray_tracer_tpu_torch.ops import wavefront_pt
from cpu_ray_tracer_tpu_torch.render import common
from cpu_ray_tracer_tpu_torch.scene import query

EPS = constants.SHADE_EPS
_STATE = ("o", "d", "seed", "throughput", "inside", "alive", "missed", "lit",
          "traversed", "tested", "locus")
# depths the wavefront kernel runs by default (0: the host bounce alone)
WAVEFRONT_DEPTHS = 1


def locus_order(d: torch.Tensor, locus: torch.Tensor) -> torch.Tensor:
    """Stable order of rays by (direction octant, previous-hit triangle)."""
    octant = (d[:, 0] < 0).long() + 2 * (d[:, 1] < 0).long() + 4 * (d[:, 2] < 0).long()
    key = (octant << 21) | torch.clamp(locus.long() + 1, 0, (1 << 21) - 1)
    return torch.argsort(key, stable=True)


def bounce_step(scene, s: dict, depth: int, depth_limit: int) -> dict:
    """Advance every ray of `s` (all alive) one path segment."""
    res = query.find_nearest(scene, s["o"], s["d"])
    t = res["t"]
    hit = res["obj_idx"] >= 0
    missed = s["missed"] | ~hit
    if depth >= depth_limit:  # the depth cutoff comes after the sky record
        hit = torch.zeros_like(hit)

    point = s["o"] + t[:, None] * s["d"]
    normal, uv, mat_id = query.get_hit_info(scene, res, point, s["d"])
    mf = query.material_fields(scene, mat_id)
    albedo = query.get_albedo(scene, mf, uv)
    is_light = mf["is_light"] & hit
    lit = s["lit"] | is_light
    surf = hit & ~is_light

    inside = s["inside"]
    medium = torch.where(
        inside[:, None], torch.exp(mf["absorption"] * (-t)[:, None]), np.float32(1.0)
    )
    seed, r_lobe = rng.random_float(s["seed"])
    refl = mf["reflectivity"]
    pick_mirror = surf & (r_lobe < refl)
    pick_diel = surf & ~pick_mirror & (r_lobe < refl + mf["refractivity"])
    pick_diff = surf & ~pick_mirror & ~pick_diel

    fr, can_refract, t_dir, r_dir = common.dielectric_terms(s["d"], normal, inside)
    seed, r_fresnel = rng.random_float(seed)
    take_refract = pick_diel & can_refract & (r_fresnel > fr)

    seed, r1 = rng.random_float(seed)
    seed, r2 = rng.random_float(seed)
    diff_dir = common.uniform_hemisphere(normal, r1, r2)
    cosr = torch.clamp_min(vm.dot(diff_dir, normal), 0.0)
    diff_w = albedo * constants.INVPI * constants.TWO_PI * cosr[:, None]

    diff = pick_diff[:, None]
    new_d = torch.where(diff, diff_dir, torch.where(take_refract[:, None], t_dir, r_dir))
    lobe_w = torch.where(diff, diff_w, albedo)  # mirror / dielectric: albedo only
    sf = surf[:, None]
    return dict(
        o=torch.where(sf, point + new_d * EPS, s["o"]),
        d=torch.where(sf, new_d, s["d"]),
        seed=seed,
        throughput=torch.where(sf, s["throughput"] * medium * lobe_w, s["throughput"]),
        inside=take_refract & ~inside,
        alive=surf,
        missed=missed,
        lit=lit,
        traversed=s["traversed"] + res["traversed"],
        tested=s["tested"] + res["tested"],
        locus=torch.where(surf, res["tri_idx"], s["locus"]),
    )


def initial_state(o, d, seeds) -> dict:
    """Per-ray path state of fresh rays (o, d) [R, 3] with seeds [R]
    (copies: `sample_radiance` updates the state in place)."""
    r, dev = o.shape[0], o.device
    return dict(
        o=o.clone(),
        d=d.clone(),
        seed=seeds.clone(),
        throughput=torch.ones((r, 3), dtype=torch.float32, device=dev),
        inside=torch.zeros(r, dtype=torch.bool, device=dev),
        alive=torch.ones(r, dtype=torch.bool, device=dev),
        missed=torch.zeros(r, dtype=torch.bool, device=dev),
        lit=torch.zeros(r, dtype=torch.bool, device=dev),
        traversed=torch.zeros(r, dtype=torch.int32, device=dev),
        tested=torch.zeros(r, dtype=torch.int32, device=dev),
        locus=torch.full((r,), -1, dtype=torch.int32, device=dev),  # previous-hit triangle
    )


def sample_radiance(scene, o, d, seeds, depth_limit: int = constants.DEPTH_LIMIT,
                    wavefront_depths: int = WAVEFRONT_DEPTHS):
    """Radiance [R, 3] along rays (o, d) [R, 3] with per-ray seeds [R]
    (uint32 values in int64), in the input ray order, and stats:
    `rays_traced` (path segments traced, an int), per-ray `traversed` and
    `tested` counters.  The first `wavefront_depths` depths run in the
    wavefront kernel (module docstring)."""
    factor = None
    first = 0
    rays_traced = 0
    if wavefront_depths > 0:
        first = min(wavefront_depths, depth_limit + 1)
        with torch.profiler.record_function(f"wavefront_{first}"):
            wf = wavefront_pt.trace(scene, o, d, seeds, first, depth_limit)
            factor = query.texel_factor(scene, wf["tex_idx"][:, 0])
            for k in range(1, first):
                factor = factor * query.texel_factor(scene, wf["tex_idx"][:, k])
        rays_traced = int(wf["live_counts"].sum())
        state = dict(
            o=wf["o"], d=wf["d"], seed=wf["seed"], throughput=wf["tp"],
            inside=wf["inside"], alive=wf["alive"], missed=wf["missed"], lit=wf["lit"],
            traversed=wf["traversed"], tested=wf["tested"], locus=wf["locus"],
        )
    else:
        state = initial_state(o, d, seeds)
    for depth in range(first, depth_limit + 1):
        live = torch.nonzero(state["alive"]).squeeze(1)
        rays_traced += live.numel()
        if live.numel() == 0:
            break
        with torch.profiler.record_function(f"depth_{depth}"):
            idx = live[locus_order(state["d"][live], state["locus"][live])]
            out = bounce_step(scene, {k: state[k][idx] for k in _STATE}, depth, depth_limit)
            for k in _STATE:
                state[k][idx] = out[k]

    tp = state["throughput"]
    radiance = torch.where(state["lit"][:, None], tp * scene.light_color, np.float32(0.0))
    sky = torch.nonzero(state["missed"]).squeeze(1)
    radiance[sky] += tp[sky] * query.sky_color(scene, state["d"][sky])
    if factor is not None:
        radiance = radiance * factor
    return radiance, dict(
        rays_traced=rays_traced, traversed=state["traversed"], tested=state["tested"]
    )


def camera_rays(camera: cam_mod.Camera, spp_index: int, device=None):
    """Jittered primary rays (o, d) [W*H, 3] in scanline order and their
    seeds: pass `spp_index` salts each pixel's seed
    (3. PathTracer/renderer.cpp:117-131)."""
    pixel_ids = torch.arange(camera.width * camera.height, dtype=torch.int64, device=device)
    seeds = rng.pixel_seeds(pixel_ids, spp_index)
    seeds, jx = rng.random_float(seeds)
    seeds, jy = rng.random_float(seeds)
    o, d = cam_mod.full_frame_rays(camera, jitter_x=jx, jitter_y=jy)
    return o, d, seeds


def render_pass(scene, camera: cam_mod.Camera, spp_index: int,
                depth_limit: int = constants.DEPTH_LIMIT,
                wavefront_depths: int = WAVEFRONT_DEPTHS):
    """One progressive pass, one jittered sample per pixel.  Returns
    (radiance [H, W, 3], stats)."""
    o, d, seeds = camera_rays(camera, spp_index, scene.device)
    radiance, stats = sample_radiance(scene, o, d, seeds, depth_limit, wavefront_depths)
    return radiance.reshape(camera.height, camera.width, 3), stats
