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

`wavefront_depths=k` runs depths [0, k) in the wavefront kernel
(`ops/wavefront_pt.py`) in one launch; at k = 1 a frame's camera rays go
to the kernel's lanes in `core/camera.lane_order` (a warp per 8x4 pixel
tile), which is faster there and slower at k = 6 on an H100 (PERF.md), so
other k keep pixel order.  Its textured hits multiply albedo 1 and record
texel indices, whose factors multiply the radiance at the end (albedo only
scales the throughput).  The rays still alive go on through the host
bounce from depth k.  k = 0 is the host bounce alone.  The kernel walks a
binary BVH's stack or link tables and reads materials from the meta word,
so it serves only such scenes (`DeviceScene.stack_kernels`, the JAX
package's `_kernel_scene_eligible`, render/pathtracer.py:473-500):
`wavefront_depths=None` takes `WAVEFRONT_DEPTHS` there and the host bounce
elsewhere (grid, KD tree, a wide-only BVH, hit ids past the meta word, a
shared-instancing scene, a scene of the reference walks, the primitive
scene); an explicit k > 0 on such a scene raises.

The ray state of the host bounce stays in pixel order.  At each depth the
live rays are gathered, ordered by (direction octant, previous hit: the
triangle, or the slot where the wavefront kernel made the hit) — the
`locus` key of the JAX package's `_compaction_perm`, which only affects
speed — bounced, and scattered back.  Depth 0 over the wide walk is the
exception: every camera ray is live, and the walk's lanes take them in
the camera's lane order (`ops/wide_bvh.py` `perm`) without a gather.
This replaces the JAX package's chunk scans, `lax.cond` skips and tier
cascade, which exist for XLA's static shapes.

On the reference route (`compile_scene(use_pallas=False)`) the counters
are the JAX package's: its XLA walks take no mask, so at every depth at
which a ray still lives it walks the dead rays too and counts their steps
(in a pass of one compaction chunk, as every pass under 4096 rays is
there).  A dead ray's origin and direction no longer change, so that
walk repeats the one in which it died, and its counters are added again
at each later depth instead of walking it anew; on a shared-instancing
scene every instance leaves a dead ray out (t0 = -1), and the walk that
costs is taken once, when the ray dies.

`differentiable=True` (the JAX package's, `sample_radiance` :1189-1410)
runs every depth through the host bounce, whose hits come from
`query.find_nearest_diff` (detached walks, t and barycentrics recomputed
with autograd), and writes the state and the sky out of place, so that
autograd reaches every parameter of `diff/grad.py`.  Its backward is
PyTorch autograd: the JAX package's custom VJPs (`_apply_perm`,
`_apply_tap_factor`, `vecmath._gather3_flat`) work around TPU scatter
costs and scan padding, and the bilinear tap is computed inline (the JAX
package's `CRT_DEFER_TEX=0` formulation).  Autograd keeps every depth's
shading intermediates where the JAX package rematerializes each bounce
(`jax.checkpoint`), which the card's memory holds (PERF.md).
"""

from __future__ import annotations

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch import constants
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.core import device as device_mod
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


def wavefront_depths_for(scene, wavefront_depths, differentiable: bool = False) -> int:
    """The depths to run in the wavefront kernel: `wavefront_depths`, or
    for None the default of the scene (module docstring); 0 for a
    differentiable pass, which runs no kernel that shades."""
    if differentiable:
        if wavefront_depths:
            raise ValueError(f"wavefront_depths={wavefront_depths} with differentiable=True: "
                             "gradients take the host bounce from depth 0")
        return 0
    if wavefront_depths is None:
        return WAVEFRONT_DEPTHS if scene.stack_kernels else 0
    if wavefront_depths > 0 and not scene.stack_kernels:
        raise ValueError(
            f"wavefront_depths={wavefront_depths}: the wavefront kernel walks the binary stack "
            f"tables, which a scene walked by {scene.walk!r} does not serve")
    return wavefront_depths


def locus_order(d: torch.Tensor, locus: torch.Tensor) -> torch.Tensor:
    """Stable order of rays by (direction octant, previous-hit triangle)."""
    octant = (d[:, 0] < 0).long() + 2 * (d[:, 1] < 0).long() + 4 * (d[:, 2] < 0).long()
    key = (octant << 21) | torch.clamp(locus.long() + 1, 0, (1 << 21) - 1)
    return torch.argsort(key, stable=True)


def bounce_step(scene, s: dict, depth: int, depth_limit: int, perm=None,
                differentiable: bool = False) -> dict:
    """Advance every ray of `s` (all alive) one path segment, the wide
    walk's lanes taking the rays in the order `perm` where given; with
    `differentiable`, t and the barycentrics of the hits carry gradients
    (`query.find_nearest_diff`)."""
    nearest = query.find_nearest_diff if differentiable else query.find_nearest
    res = nearest(scene, s["o"], s["d"], perm)
    t = res["t"]
    hit = res["obj_idx"] >= 0
    missed = s["missed"] | ~hit
    if depth >= depth_limit:  # the depth cutoff comes after the sky record
        hit = torch.zeros_like(hit)

    point = s["o"] + t[:, None] * s["d"]
    normal, uv, mat_id = query.get_hit_info(scene, res, point, s["d"])
    mf = query.material_fields(scene, mat_id)
    albedo = query.get_albedo(scene, mf, uv, res["obj_idx"], point)
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


def _idle_walks(scene, idle: dict, idx: torch.Tensor, state: dict, out: dict) -> None:
    """Record in `idle` the counters the JAX package's XLA route adds for
    each ray of `idx` that died in this bounce (`out`, from `state`) at
    every later depth: those of the walk it died in, or on a shared scene
    those of a walk that every instance leaves out of (module
    docstring)."""
    died = torch.nonzero(~out["alive"]).squeeze(1)
    if scene.shared is None:
        walk = {k: out[k][died] - state[k][idx[died]] for k in idle}
    else:
        o, d = out["o"][died], out["d"][died]
        walk = query.triangle_hit(scene, o, d, torch.full_like(o[:, 0], constants.RAY_FAR),
                                  mask=torch.zeros_like(died, dtype=torch.bool))
    for k in idle:
        idle[k][idx[died]] = walk[k]


def initial_state(o, d, seeds) -> dict:
    """Per-ray path state of fresh rays (o, d) [R, 3] with seeds [R]
    (copies: `sample_radiance` updates the state in place)."""
    r, dev = o.shape[0], o.device
    return dict(
        o=o.clone(),
        d=d.clone(),
        seed=seeds.clone(),
        throughput=torch.ones((r, 3), dtype=o.dtype, device=dev),
        inside=torch.zeros(r, dtype=torch.bool, device=dev),
        alive=torch.ones(r, dtype=torch.bool, device=dev),
        missed=torch.zeros(r, dtype=torch.bool, device=dev),
        lit=torch.zeros(r, dtype=torch.bool, device=dev),
        traversed=torch.zeros(r, dtype=torch.int32, device=dev),
        tested=torch.zeros(r, dtype=torch.int32, device=dev),
        locus=torch.full((r,), -1, dtype=torch.int32, device=dev),  # previous-hit triangle
    )


def sample_radiance(scene, o, d, seeds, depth_limit: int = constants.DEPTH_LIMIT,
                    wavefront_depths: int | None = None, perm=None,
                    differentiable: bool = False):
    """Radiance [R, 3] along rays (o, d) [R, 3] with per-ray seeds [R]
    (uint32 values in int64), in the input ray order, and stats:
    `rays_traced` (path segments traced, an int), per-ray `traversed` and
    `tested` counters.  The first `wavefront_depths` depths run in the
    wavefront kernel (module docstring), its lanes taking the rays in the
    order `perm` int32 [R] where given and the kernel runs one depth; on
    the wide walk, depth 0 of the host bounce takes them in that order.
    `differentiable=True`: the radiance carries gradients (module
    docstring); an explicit `wavefront_depths` > 0 then raises."""
    wavefront_depths = wavefront_depths_for(scene, wavefront_depths, differentiable)
    factor = None
    first = 0
    rays_traced = 0
    if wavefront_depths > 0:
        first = min(wavefront_depths, depth_limit + 1)
        with torch.profiler.record_function(f"wavefront_{first}"):
            wf = wavefront_pt.trace(scene, o, d, seeds, first, depth_limit,
                                    perm=perm if first == 1 else None)
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
    # the reference route's counters of a walk of each dead ray (module docstring)
    idle = None if scene.reference is None else dict(
        traversed=torch.zeros_like(state["traversed"]), tested=torch.zeros_like(state["tested"]))
    for depth in range(first, depth_limit + 1):
        live = torch.nonzero(state["alive"]).squeeze(1)
        rays_traced += live.numel()
        if live.numel() == 0:
            break
        if idle is not None:
            for k in idle:
                state[k] = state[k] + idle[k]
        with torch.profiler.record_function(f"depth_{depth}"):
            if depth == 0 and query.wide_perm(scene, perm) is not None:
                # every camera ray, in pixel order, to the wide walk's
                # lanes in the camera's lane order
                state.update(bounce_step(scene, state, depth, depth_limit, perm,
                                         differentiable))
                continue
            idx = live[locus_order(state["d"][live], state["locus"][live])]
            out = bounce_step(scene, {k: state[k][idx] for k in _STATE}, depth, depth_limit,
                              differentiable=differentiable)
            if idle is not None:
                _idle_walks(scene, idle, idx, state, out)
            if differentiable:  # autograd saves tensors that a write in place would change
                state = {k: state[k].index_copy(0, idx, out[k]) for k in _STATE}
            else:
                for k in _STATE:
                    state[k][idx] = out[k]

    tp = state["throughput"]
    radiance = torch.where(state["lit"][:, None], tp * scene.light_color, np.float32(0.0))
    sky = torch.nonzero(state["missed"]).squeeze(1)
    sky_rad = tp[sky] * query.sky_color(scene, state["d"][sky])
    if differentiable:
        radiance = radiance.index_add(0, sky, sky_rad)
    else:
        radiance[sky] += sky_rad
    if factor is not None:
        radiance = radiance * factor
    return radiance, dict(
        rays_traced=rays_traced, traversed=state["traversed"], tested=state["tested"]
    )


def camera_rays(camera: cam_mod.Camera, spp_index: int, device=device_mod.DEFAULT,
                samples_per_pass: int = 1):
    """Jittered primary rays (o, d) [s*W*H, 3] and their seeds, `s` =
    `samples_per_pass` adjacent rays a pixel in scanline order of pixels,
    on `device` (the card unless the caller asks for another): sample k of
    a pixel salts its seed with `spp_index` + k (3. PathTracer/
    renderer.cpp:117-131), so the s samples are those of s one-sample
    passes at spp_index, spp_index + 1, ..."""
    if samples_per_pass < 1:
        raise ValueError(f"samples_per_pass={samples_per_pass}: expected 1 or more")
    s, dev = samples_per_pass, device_mod.resolve(device)
    n = camera.width * camera.height
    pixel_ids = torch.arange(n, dtype=torch.int64, device=dev).repeat_interleave(s)
    sample_k = torch.arange(s, dtype=torch.int64, device=dev).repeat(n)
    seeds = rng.pixel_seeds(pixel_ids, spp_index + sample_k)
    seeds, jx = rng.random_float(seeds)
    seeds, jy = rng.random_float(seeds)
    xs, ys = cam_mod.pixel_grid(camera, dev)
    o, d = cam_mod.primary_rays(camera, xs.repeat_interleave(s) + jx,
                                ys.repeat_interleave(s) + jy)
    return o, d, seeds


def render_pass(scene, camera: cam_mod.Camera, spp_index: int,
                depth_limit: int = constants.DEPTH_LIMIT,
                wavefront_depths: int | None = None, differentiable: bool = False,
                samples_per_pass: int = 1):
    """One progressive pass of `samples_per_pass` jittered samples a pixel
    (the JAX package's megapass, render/pathtracer.py:1413-1476: the rays
    pixel-major, sample k salted `spp_index` + k, so it draws the samples
    of that many one-sample passes), on the scene's device.  Returns
    (radiance [H, W, 3], the SUM of each pixel's samples, and stats, with
    `rays_traced` over every sample); with `differentiable` the radiance
    carries gradients to the scene's parameters
    (`diff/grad.apply_params`)."""
    s = samples_per_pass
    o, d, seeds = camera_rays(camera, spp_index, scene.device, s)
    radiance, stats = sample_radiance(scene, o, d, seeds, depth_limit, wavefront_depths,
                                      cam_mod.lane_order(camera, scene.device, s),
                                      differentiable)
    return radiance.reshape(camera.height, camera.width, s, 3).sum(dim=2), stats
