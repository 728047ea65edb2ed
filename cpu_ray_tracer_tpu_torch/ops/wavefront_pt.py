"""Wavefront path tracer: k bounce depths per launch, the CUDA kernel's
wrapper (`trace`) and its plain PyTorch version (`trace_plain`).

The port of the JAX package's in-kernel bounce wavefront
(cpu_ray_tracer_tpu/ops/pallas/wavefront_pt.py: `_kernel` :165, `trace`
:518); the per-ray math is described in `csrc/wavefront_pt.cu`.  Both
functions take (scene, o, d, seeds, k_depths, depth_limit, alive=None,
inside=None, depth_base=0) — rays (o, d) [R, 3], seeds [R] (uint32 values
in int64, as `core/rng` carries them), optional alive / inside [R] bool —
run depths depth_base + [0, k_depths), and return, in the input order:

    tp            float32 [R, 3]  throughput factor of those depths, texel
                                  factors excluded (starts at 1)
    o, d          float32 [R, 3]  continuation ray, or the terminal one
    seed          int64 [R]       seed after the depths' draws
    missed, lit, alive, inside    bool [R]
    tex_idx       int32 [R, K]    nearest-texel index per depth, -1 where
                                  the hit had no texture
    locus         int32 [R]       slot of the last surface hit (-1: none)
    traversed, tested             int32 [R]  walk steps and triangle tests
    live_counts   int32 [K]       rays alive entering each depth

Rays dead on entry pass through unchanged.  `trace` runs the plain version
for tensors on the CPU and launches the kernel for tensors on a CUDA
device; there is no other fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch import constants
from cpu_ray_tracer_tpu_torch.core import rng
from cpu_ray_tracer_tpu_torch.ops import kernel_lib, surface

_F32 = torch.float32
_KEYS = ("tp", "o", "d", "seed", "missed", "lit", "alive", "inside", "tex_idx", "locus",
         "traversed", "tested")


def _bounce(scene, s: dict, cutoff: bool) -> dict:
    """One depth of the kernel's per-ray loop for rays that are all alive
    (`s` holds their o, d, seed, inside, tp); `cutoff` ends the paths."""
    o, d, inside = s["o"], s["d"], s["inside"]
    sf = surface.nearest_surface(scene, o, d)
    hit = sf["obj"] >= 0
    missed = ~hit
    if cutoff:
        hit = torch.zeros_like(hit)
    m = sf["mat"].long()
    is_light = hit & scene.mat_is_light[m]
    surf = hit & ~is_light
    absorption = scene.mat_absorption[m]
    med = torch.where(inside[:, None], torch.exp(absorption * (-sf["t"])[:, None]), np.float32(1.0))
    refl, refr = scene.mat_reflectivity[m], scene.mat_refractivity[m]
    seed, r_lobe = rng.random_float(s["seed"])
    pick_mirror = surf & (r_lobe < refl)
    pick_diel = surf & ~pick_mirror & (r_lobe < refl + refr)
    pick_diff = surf & ~pick_mirror & ~pick_diel
    dl = surface.dielectric(d, sf["n"], inside)
    seed, r_fresnel = rng.random_float(seed)
    take_refract = pick_diel & dl["can"] & (r_fresnel > dl["fr"])

    # uniform hemisphere about the normal, Frisvad basis
    seed, z = rng.random_float(seed)
    seed, r2 = rng.random_float(seed)
    phi = constants.TWO_PI * r2
    rxy = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    hx, hy = rxy * torch.cos(phi), rxy * torch.sin(phi)
    nx, ny, nz = sf["n"]
    one = np.float32(1.0)
    sgn = torch.where(nz >= 0.0, one, -one)
    af = -1.0 / (sgn + nz)
    bf = nx * ny * af
    t1x = 1.0 + sgn * nx * nx * af
    t1y = sgn * bf
    t1z = -sgn * nx
    t2y = sgn + ny * ny * af
    dd = (t1x * hx + bf * hy + nx * z, t1y * hx + t2y * hy + ny * z, t1z * hx + -ny * hy + nz * z)
    cosr = torch.clamp_min(dd[0] * nx + dd[1] * ny + dd[2] * nz, 0.0)

    tex = torch.where(surf, surface.texel_index(scene, sf["mat"], sf["u"], sf["v"]), -1)
    alb = torch.where((tex >= 0)[:, None], one, scene.mat_albedo[m])
    dw = surface.INV2PI_W * cosr
    lw = torch.where(pick_diff[:, None], alb * dw[:, None], alb)
    new_d = torch.stack([
        torch.where(pick_diff, dd[k], torch.where(take_refract, dl["t"][k], dl["r"][k]))
        for k in range(3)
    ], dim=1)
    sfc = surf[:, None]
    point = torch.stack(sf["p"], dim=1)
    return dict(
        tp=torch.where(sfc, s["tp"] * med * lw, s["tp"]),
        o=torch.where(sfc, point + new_d * surface.EPS, o),
        d=torch.where(sfc, new_d, d),
        seed=seed,
        missed=missed,
        lit=is_light,
        alive=surf,
        inside=take_refract & ~inside,
        tex=tex.to(torch.int32),
        locus=sf["slot"],
        surf=surf,
        traversed=sf["traversed"],
        tested=sf["tested"],
    )


def trace_plain(scene, o, d, seeds, k_depths: int, depth_limit: int,
                alive=None, inside=None, depth_base: int = 0) -> dict:
    """The kernel's per-ray loop in plain PyTorch, lockstep over the rays:
    each depth gathers the live rays, advances them and scatters back."""
    r, dev = o.shape[0], o.device
    i32 = dict(dtype=torch.int32, device=dev)
    false = torch.zeros(r, dtype=torch.bool, device=dev)
    out = dict(
        tp=torch.ones((r, 3), dtype=_F32, device=dev),
        o=o.clone(), d=d.clone(), seed=seeds.clone(),
        missed=false.clone(), lit=false.clone(),
        alive=~false if alive is None else alive.clone(),
        inside=false.clone() if inside is None else inside.clone(),
        tex_idx=torch.full((r, k_depths), -1, **i32),
        locus=torch.full((r,), -1, **i32),
        traversed=torch.zeros(r, **i32), tested=torch.zeros(r, **i32),
    )
    live_counts = []
    for depth in range(k_depths):
        ids = torch.nonzero(out["alive"]).squeeze(1)
        live_counts.append(ids.numel())
        if ids.numel() == 0:
            continue
        s = {k: out[k][ids] for k in ("o", "d", "seed", "inside", "tp")}
        b = _bounce(scene, s, depth_base + depth >= depth_limit)
        for k in ("tp", "o", "d", "seed", "alive", "inside"):
            out[k][ids] = b[k]
        out["missed"][ids] |= b["missed"]
        out["lit"][ids] |= b["lit"]
        out["tex_idx"][ids, depth] = b["tex"]
        out["locus"][ids] = torch.where(b["surf"], b["locus"], out["locus"][ids])
        out["traversed"][ids] += b["traversed"]
        out["tested"][ids] += b["tested"]
    out["live_counts"] = torch.tensor(live_counts, **i32)
    return out


def trace(scene, o, d, seeds, k_depths: int, depth_limit: int,
          alive=None, inside=None, depth_base: int = 0) -> dict:
    """k_depths bounce depths of rays (o, d): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (module docstring)."""
    if kernel_lib.on_cpu("wavefront_pt.trace", o):
        return trace_plain(scene, o, d, seeds, k_depths, depth_limit, alive, inside, depth_base)
    if k_depths < 1:
        raise ValueError(f"wavefront_pt.trace: k_depths {k_depths} < 1")
    r, dev = o.shape[0], o.device
    kernel_lib.require(
        "wavefront_pt.trace", dev,
        o=(o, _F32, (r, 3)), d=(d, _F32, (r, 3)), seeds=(seeds, torch.int64, (r,)),
        alive=(alive, torch.bool, (r,)), inside=(inside, torch.bool, (r,)),
        nodes=(scene.nodes, torch.int32, None), tris=(scene.tris, _F32, None),
        shade=(scene.shade, _F32, None),
    )
    params = surface.params(scene)
    k = kernel_lib.load()
    f32 = dict(dtype=_F32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    b8 = dict(dtype=torch.bool, device=dev)
    out = dict(
        tp=torch.empty((r, 3), **f32), o=torch.empty((r, 3), **f32),
        d=torch.empty((r, 3), **f32), seed=torch.empty(r, dtype=torch.int64, device=dev),
        missed=torch.empty(r, **b8), lit=torch.empty(r, **b8), alive=torch.empty(r, **b8),
        inside=torch.empty(r, **b8), tex_idx=torch.empty((r, k_depths), **i32),
        locus=torch.empty(r, **i32), traversed=torch.empty(r, **i32),
        tested=torch.empty(r, **i32), live_counts=torch.zeros(k_depths, **i32),
    )
    code = k.lib.crt_wavefront_pt(
        o.data_ptr(), d.data_ptr(), seeds.data_ptr(), kernel_lib.ptr(alive),
        kernel_lib.ptr(inside), r, scene.nodes.data_ptr(), scene.tris.data_ptr(),
        scene.shade.data_ptr(), scene.root, params.data_ptr(), scene.material_count,
        k_depths, depth_limit, depth_base,
        *(out[key].data_ptr() for key in (*_KEYS, "live_counts")),
        kernel_lib.stream(dev),
    )
    kernel_lib.check(k.lib, code, "wavefront_pt")
    trace.launches += 1
    return out


trace.launches = 0  # kernel launches since the last reset
