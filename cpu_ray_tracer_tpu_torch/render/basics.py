"""Primary-ray AOV renderer, as the JAX package's
`cpu_ray_tracer_tpu/render/basics.py`: the reference's "1. Basics" project
(1. Basics/renderer.cpp:15-26) plus the debug AOVs that are commented-out
one-liners in the other integrators (2. WhittedStyle/renderer.cpp:34-39):
albedo, normal, depth, edges, object id, and the traversal/test heatmaps.

The nearest hit is `query.find_nearest`: the closest-hit kernel of the
scene's walk on the card (the stack walk on a BVH, the link walk on the
grid and KD cell forests), its plain version on the CPU.  Its counters
are per ray, where the JAX package's packet kernels count per tile
(ROADMAP queue 3), so the two heatmaps differ from the JAX package's by
that.  On a scene of the reference walks (`compile_scene(use_pallas=
False)`) the counters are the reference's, and the heatmaps equal the
JAX package's on its `use_pallas=False` scene."""

from __future__ import annotations

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.render import debug
from cpu_ray_tracer_tpu_torch.scene import query

AOV_KINDS = ("albedo", "normal", "depth", "edges", "traversal", "tests", "obj_id")
_ZERO = np.float32(0.0)


def render(scene, camera: cam_mod.Camera, aov: str = "albedo") -> torch.Tensor:
    """One AOV frame [H, W, 3] of unjittered primary rays, on the scene's
    device."""
    o, d = cam_mod.full_frame_rays(camera, device=scene.device)
    return aov_of_rays(scene, o, d, aov).reshape(camera.height, camera.width, 3)


def aov_of_rays(scene, o: torch.Tensor, d: torch.Tensor, aov: str = "albedo") -> torch.Tensor:
    """The AOV `aov` [R, 3] along rays (o, d) [R, 3]; the heatmaps scale by
    the largest count among these rays."""
    if aov not in AOV_KINDS:
        raise ValueError(f"unknown AOV {aov!r}; expected one of {AOV_KINDS}")
    res = query.find_nearest(scene, o, d)
    hit = (res["obj_idx"] >= 0)[:, None]
    if aov in ("albedo", "normal"):
        point = o + res["t"][:, None] * d
        normal, uv, mat_id = query.get_hit_info(scene, res, point, d)
    if aov == "albedo":
        albedo = query.get_albedo(scene, query.material_fields(scene, mat_id), uv,
                                  res["obj_idx"], point)
        img = torch.where(hit, albedo, _ZERO)
    elif aov == "normal":
        img = torch.where(hit, (normal + 1.0) * 0.5, _ZERO)
    elif aov == "depth":
        img = torch.where(hit, 0.1 * res["t"][:, None].expand(-1, 3), _ZERO)
    elif aov == "edges":
        img = debug.edge_color(torch.stack([res["u"], res["v"]], dim=-1))
    elif aov in ("traversal", "tests"):
        count = res["traversed" if aov == "traversal" else "tested"]
        img = debug.traverse_count_color(count, count.max())
    else:
        img = debug.id_color(res["obj_idx"])
    return img


def probe(scene, camera: cam_mod.Camera, x: float, y: float) -> dict:
    """Single-ray scene query at pixel coordinates (x, y): the reference's
    ImGui "object id under the mouse" readout (2. WhittedStyle/
    renderer.cpp:215-217).  Returns Python scalars obj_idx, tri_idx, t."""
    xy = torch.tensor([[float(x)], [float(y)]], dtype=torch.float32, device=scene.device)
    o, d = cam_mod.primary_rays(camera, xy[0], xy[1])
    res = query.find_nearest(scene, o, d)
    return dict(obj_idx=int(res["obj_idx"][0]), tri_idx=int(res["tri_idx"][0]),
                t=float(res["t"][0]))
