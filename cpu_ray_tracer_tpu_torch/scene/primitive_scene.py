"""The reference's analytic PrimitiveScene (infra/scene/primitive_scene.cpp,
template/scene.h), as the JAX package's
`cpu_ray_tracer_tpu/scene/primitive_scene.py`: a swinging quad light, a
bouncing mirror sphere, a giant sphere that rounds the room's corners, a
spinning dielectric cube, six walls (red, blue and checkerboard albedo
overrides) and a dielectric torus.  No triangles: every query is closed
form (`ops/primitives.py`, `ops/intersect.py`), and no kernel runs.

Object ids are the reference's: 0 quad light, 1 sphere, 2 sphere 2, 3
cube, 4-9 the planes (left, right, floor, ceiling, front, back), 10 the
torus; the material slot is the object id, slot 11 the error material.
`compile_primitive_scene(anim_time)` is SetTime (primitive_scene.cpp:
43-68): the scene at that time.

The walls' textures are the upstream repository's red.png, blue.png and
logo.png, read from the directory `CRT_UPSTREAM_ASSETS` names; where it
is unset or lacks them, each is a 4x4 texture of 0.93, as in the JAX
package.  The wall lookup indexes the atlas as if each texture were
512x512 (template/primitives.h:134-179); past the atlas's end (the
fallback textures) the index is clamped to its last texel, as XLA clamps
a gather (ROADMAP queue 3).

The torus's closed-form quartic is ill-conditioned in float32: near
grazing rays and double roots the last bits of `acos`, `cos` and the cube
root (which differ between the card, the CPU and XLA) decide whether a
ray hits, by whole pixels (a shadow ray grazing the torus, measured on an
H100 against the CPU).  The reference solves it in double, and so does
the port (`TORUS_DTYPE`), on the card and the CPU alike; the JAX package
solves it in float32, a TPU's widest float.  `torus_sensitive` tells the
pixels where that choice decides the value: it renders them again with
the torus solved in float32.

`PrimScene` carries the fields the shared queries read (`mat_*`, the
light, `skydome_tex` -1: no sky) and `stack_kernels` False, so the
integrators take their host routes (`scene/query.py` dispatches on it).
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
from torch import nn

from cpu_ray_tracer_tpu_torch import constants
from cpu_ray_tracer_tpu_torch.core import device as device_mod
from cpu_ray_tracer_tpu_torch.core import vecmath as vm
from cpu_ray_tracer_tpu_torch.core.materials import make_table
from cpu_ray_tracer_tpu_torch.core.textures import build_atlas
from cpu_ray_tracer_tpu_torch.io.image import load_texture_image
from cpu_ray_tracer_tpu_torch.ops import intersect
from cpu_ray_tracer_tpu_torch.ops import primitives as prim
from cpu_ray_tracer_tpu_torch.scene.types import register_materials

WALL_TEXTURES = ("red.png", "blue.png", "logo.png")  # atlas textures 0, 1, 2
WALL_SIZE = 512  # the wall lookup's texture width and height (primitives.h)
N_OBJECTS = 11
TORUS_DTYPE = torch.float64  # the torus solve's precision: the reference's double
_MATERIALS = (
    {"is_light": True},  # 0 light
    {"reflectivity": 1.0},  # 1 bouncing ball (mirror)
    {},  # 2 rounded corners
    {"refractivity": 1.0, "absorption": (0.5, 0.0, 0.5)},  # 3 cube
    {},  # 4 left wall (albedo override: red)
    {},  # 5 right wall (albedo override: blue)
    {"reflectivity": 0.3},  # 6 floor (albedo override: checkerboard)
    {},  # 7 ceiling
    {},  # 8 front wall
    {},  # 9 back wall
    {"refractivity": 1.0},  # 10 torus
    {"albedo": (1.0, 192 / 255.0, 203 / 255.0)},  # 11 error pink
)
_PLANE_N = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))
_PLANE_D = (3.0, 2.99, 1.0, 2.0, 3.0, 3.99)


def wall_texture(name: str) -> np.ndarray:
    """The upstream wall texture `name` from `CRT_UPSTREAM_ASSETS`, or the
    4x4 fallback of 0.93."""
    root = os.environ.get("CRT_UPSTREAM_ASSETS")
    path = os.path.join(root, name) if root else None
    if path and os.path.isfile(path):
        return load_texture_image(path)
    return np.full((4, 4, 3), 0.93, np.float32)


class PrimScene(nn.Module):
    """The scene's tables as buffers (`.to(device)` moves them all): the
    materials and the walls' atlas (`register_materials`), the light
    (`light_t`, `light_inv_t`, `light_size`, `light_color`), the spheres
    (`sphere_pos` [2, 3], `sphere_r2`, `sphere_inv_r` [2]), the cube
    (`cube_m`, `cube_inv_m` [4, 4], `cube_bmin`, `cube_bmax` [3]), the
    planes (`plane_n` [6, 3], `plane_d` [6]) and the torus (`torus_t`,
    `torus_inv_t` [4, 4], `torus_rc2`, `torus_rt2`, `torus_r2`)."""

    walk = "analytic"
    stack_kernels = False
    reference = None  # the closed forms answer every query: no reference walk
    skydome_tex = -1

    def __init__(self, arrays: dict, atlas):
        super().__init__()
        register_materials(self, make_table(list(_MATERIALS)), atlas)
        for name, x in arrays.items():
            self.register_buffer(name, torch.from_numpy(np.array(x, np.float32)))

    @property
    def device(self) -> torch.device:
        return self.light_t.device

    @property
    def material_count(self) -> int:
        return self.mat_albedo.shape[0]


def scene_arrays(anim_time: float = 0.0) -> dict:
    """The float32 tables of `PrimScene` at `anim_time` (SetTime)."""
    pi = np.float32(np.pi)
    # the light: a swinging quad
    m1 = (vm.mat_translate((0.0, 2.6, 2.0))
          @ vm.mat_rotate_z(np.sin(np.float32(anim_time) * 0.6) * 0.1)
          @ vm.mat_translate((0.0, -0.9, 0.0)))
    # the cube: a spin
    m2base = vm.mat_rotate_x(pi / 4) @ vm.mat_rotate_z(pi / 4)
    m2 = vm.mat_translate((1.8, 0.0, 2.5)) @ vm.mat_rotate_y(np.float32(anim_time) * 0.5) @ m2base
    # the sphere: a bounce
    tm = 1.0 - (np.fmod(np.float32(anim_time), 2.0) - 1.0) ** 2
    sphere_r = np.array([0.6, 8.0], np.float32)
    torus_t = vm.mat_translate((-0.25, 0.0, 2.0)) @ vm.mat_rotate_x(pi / 4)
    rc, rt = np.float32(0.8), np.float32(0.25)
    return dict(
        light_t=m1, light_inv_t=vm.mat_inverted_no_scale(m1), light_size=np.float32(0.5),
        light_color=constants.LIGHT_COLOR,
        sphere_pos=np.array([[-1.8, -0.4 + tm, 1.0], [0.0, 2.5, -3.07]], np.float32),
        sphere_r2=sphere_r * sphere_r, sphere_inv_r=1.0 / sphere_r,
        cube_m=m2, cube_inv_m=vm.mat_inverted_no_scale(m2),
        cube_bmin=np.full(3, -0.575, np.float32), cube_bmax=np.full(3, 0.575, np.float32),
        plane_n=np.array(_PLANE_N, np.float32), plane_d=np.array(_PLANE_D, np.float32),
        torus_t=torus_t, torus_inv_t=vm.mat_inverted(torus_t), torus_rc2=rc * rc,
        torus_rt2=rt * rt, torus_r2=(rc + rt) ** 2,
    )


def compile_primitive_scene(anim_time: float = 0.0, device=device_mod.DEFAULT) -> PrimScene:
    """The primitive scene at `anim_time` on `device` (the card unless the
    caller asks for another; without a CUDA device the default raises)."""
    dev = device_mod.resolve(device)
    atlas = build_atlas([wall_texture(name) for name in WALL_TEXTURES])
    return PrimScene(scene_arrays(anim_time), atlas).to(dev)


def find_nearest(scene: PrimScene, o: torch.Tensor, d: torch.Tensor) -> dict:
    """Nearest of the eleven objects (primitive_scene.cpp FindNearest), in
    the reference's order; the port's hit dict (`scene/query.find_nearest`)
    with no triangle: `tri_idx`, `slot` -1, `u`, `v` 0, `traversed` 0,
    `tested` 11.  Differentiable in o and d: t is closed form."""
    r, dev = o.shape[0], o.device
    t = torch.full((r,), constants.RAY_FAR, dtype=torch.float32, device=dev)
    obj = torch.full((r,), -1, dtype=torch.int32, device=dev)

    def take(hit_t, k):
        nonlocal t, obj
        t = torch.where(hit_t[1], hit_t[0], t)
        obj = torch.where(hit_t[1], k, obj)

    take(intersect.quad(o, d, scene.light_inv_t, scene.light_size, t), 0)
    for i in range(2):
        take(prim.sphere(o, d, scene.sphere_pos[i], scene.sphere_r2[i], t), 1 + i)
    take(prim.cube(o, d, scene.cube_inv_m, scene.cube_bmin, scene.cube_bmax, t), 3)
    for i in range(6):
        take(intersect.plane(o, d, scene.plane_n[i], scene.plane_d[i], t), 4 + i)
    take(_torus(scene, o, d, t), 10)
    minus1 = torch.full((r,), -1, dtype=torch.int32, device=dev)
    zero_f = torch.zeros(r, dtype=torch.float32, device=dev)
    zero_i = torch.zeros(r, dtype=torch.int32, device=dev)
    return dict(t=t, obj_idx=obj, tri_idx=minus1, slot=minus1, u=zero_f, v=zero_f,
                mat_id_tri=minus1, traversed=zero_i, tested=torch.full_like(zero_i, N_OBJECTS))


def is_occluded(scene: PrimScene, o, d, dist) -> torch.Tensor:
    """The reference's shadow query (primitive_scene.cpp IsOccluded): the
    cube, sphere 1, the quad and the torus within `dist`; the planes and
    sphere 2 never occlude."""
    _, chit = prim.cube(o, d, scene.cube_inv_m, scene.cube_bmin, scene.cube_bmax, dist)
    _, shit = prim.sphere(o, d, scene.sphere_pos[0], scene.sphere_r2[0], dist)
    _, qhit = intersect.quad(o, d, scene.light_inv_t, scene.light_size, dist)
    _, thit = _torus(scene, o, d, dist)
    return chit | shit | qhit | thit


def _torus(scene: PrimScene, o, d, t_max):
    """(t float32 [R], hit) of the torus, solved in TORUS_DTYPE."""
    dt = TORUS_DTYPE
    t, hit = prim.torus(o.to(dt), d.to(dt), scene.torus_inv_t.to(dt), scene.torus_rc2.to(dt),
                        scene.torus_rt2.to(dt), scene.torus_r2.to(dt), t_max.to(dt))
    # a float64 t below t_max may round up to it
    return torch.where(hit, t.to(torch.float32), t_max), hit


def get_hit_info(scene: PrimScene, hit: dict, point, d):
    """Normal (back-face flipped), uv (0) and material id (the object id,
    the error material for a miss) per ray."""
    obj = hit["obj_idx"][:, None]
    n = torch.zeros_like(point)
    n = torch.where(obj == 0, -scene.light_t[:3, 1], n)
    for i in range(2):
        n = torch.where(obj == 1 + i,
                        prim.sphere_normal(point, scene.sphere_pos[i], scene.sphere_inv_r[i]), n)
    n = torch.where(obj == 3, prim.cube_normal(point, scene.cube_m, scene.cube_inv_m,
                                               scene.cube_bmin, scene.cube_bmax), n)
    for i in range(6):
        n = torch.where(obj == 4 + i, scene.plane_n[i], n)
    n = torch.where(obj == 10, prim.torus_normal(point, scene.torus_t, scene.torus_inv_t,
                                                 scene.torus_rc2, scene.torus_rt2), n)
    flip = (vm.dot(n, d) > 0)[:, None]
    n = torch.where(flip, -n, n)
    mat_id = torch.where(obj[:, 0] >= 0, obj[:, 0], scene.material_count - 1)
    return n, torch.zeros(point.shape[0], 2, dtype=torch.float32, device=point.device), mat_id


def get_albedo_override(scene: PrimScene, obj, point) -> torch.Tensor:
    """The planes' albedo overrides (template/primitives.h:134-179): the
    floor's checkerboard with its two deliberately aliased tiles, the left
    wall red.png, the right wall blue.png, 0.93 elsewhere.  [R, 3]."""
    p = point

    def cell(axis, scale, shift=None):
        x = p[:, axis] * np.float32(scale)
        return (x if shift is None else x + np.float32(shift)).to(torch.int32)

    ix, iz = cell(0, 2, 96.01), cell(2, 2, 96.01)
    alias1 = (ix == 98) & (iz == 98)
    alias2 = (ix == 94) & (iz == 98)
    ix = torch.where(alias1, cell(0, 32.01), torch.where(alias2, cell(0, 64.01), ix))
    iz = torch.where(alias1, cell(2, 32.01), torch.where(alias2, cell(2, 64.01), iz))
    checker = torch.where(((ix + iz) & 1) == 1, np.float32(1.0), np.float32(0.3))[:, None]
    last = scene.atlas_texels.shape[0] - 1

    def wall(tex_id):
        w = h = WALL_SIZE
        wx = ((p[:, 2] - 4.0) * (w / 7.0)).to(torch.int32) & (w - 1)
        wy = ((2.0 - p[:, 1]) * (h / 3.0)).to(torch.int32) & (h - 1)
        idx = scene.atlas_offset[tex_id].long() + wx.long() + wy.long() * w
        return scene.atlas_texels[idx.clamp(0, last)]

    out = torch.full_like(point, np.float32(0.93))
    obj = obj[:, None]
    out = torch.where(obj == 6, checker.expand_as(out), out)
    out = torch.where(obj == 4, wall(0), out)  # red.png
    return torch.where(obj == 5, wall(1), out)  # blue.png


@contextlib.contextmanager
def float32_torus():
    """Within the block the scene's torus is solved in float32, as the JAX
    package solves it: the probe of `torus_sensitive`."""
    global TORUS_DTYPE
    saved, TORUS_DTYPE = TORUS_DTYPE, torch.float32
    try:
        yield
    finally:
        TORUS_DTYPE = saved


def torus_sensitive(radiance, o, d, seeds, atol: float = 2e-5, rtol: float = 1e-4) -> torch.Tensor:
    """Bool [P] on the CPU: whether the radiance along rays (o, d) [P, 3]
    (with `seeds` [P] or None; `radiance(o, d, seeds)` as in
    `render/borderline.py`) changes beyond (atol, rtol) when the torus is
    solved in float32 instead of float64: the quartic's float32 rounding
    decides those pixels, and a float32 solver (the JAX package's) may
    disagree with the port there."""
    base = radiance(o, d, seeds)
    with float32_torus():
        ref = radiance(o, d, seeds)
    return (~torch.isclose(base, ref, atol=atol, rtol=rtol).all(dim=-1)).cpu()
