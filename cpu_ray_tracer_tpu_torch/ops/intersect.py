"""Batched intersection tests, as the JAX package's
`cpu_ray_tracer_tpu/ops/intersect.py`: Moller-Trumbore and the slab test
of the reference walks (the reference's infra/bvh.cpp:181-222), the
closed-form quad and plane and the floor's UV mapping
(template/primitives.h:100-179, :321-375).  Branchless, masks instead of
early returns, the same float32 operation order: `dot` and the cross
products of Moller-Trumbore are the JAX package's `vecmath.dot` (a sum
over the last axis, left to right) and `jnp.cross` (a1 b2 - a2 b1, ...:
the lanes rolled by `roll3`), written as one elementwise operation per
term, so that the card and the CPU round alike (no reduction or fused
multiply-add whose order a library picks)."""

from __future__ import annotations

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch import constants
from cpu_ray_tracer_tpu_torch.core import vecmath as vm

_TINY = np.float32(1e-20)
_TINY_MT = np.float32(1e-30)
FLOOR_NORMAL = np.array([0.0, 1.0, 0.0], np.float32)
FLOOR_D = np.float32(1.0)


def roll3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., 3] with its lanes rolled by one and by two: (yzx, zxy)."""
    return x[..., [1, 2, 0]], x[..., [2, 0, 1]]


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a0 b0 + a1 b1) + a2 b2 over the last axis."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def moller_trumbore(o, d, v0, e1, e2, t_max):
    """Moller-Trumbore of rays o, d [..., 3] against triangles v0, e1, e2
    [..., 3] (broadcast), with t_max [...] the current nearest t: (t, u,
    v, hit).  The semantics of infra/bvh.cpp:203-222: |det| < TRI_EPS
    rejected, u, v in [0, 1], u + v <= 1, TRI_EPS < t < t_max."""
    return mt_rolled(o, roll3(o), d, roll3(d), v0, roll3(v0), e1, roll3(e1), e2, roll3(e2), t_max)


def mt_rolled(o, o_r, d, d_r, v0, v0_r, e1, e1_r, e2, e2_r, t_max):
    """`moller_trumbore` with each vector's `roll3` given (the walks keep
    the rays' rolls and the triangles' rolls in their records, so that a
    test gathers no lanes)."""
    h = d_r[0] * e2_r[1] - d_r[1] * e2_r[0]  # cross(d, e2)
    a = dot(e1, h)
    abs_a = a.abs()
    f = 1.0 / torch.where(abs_a < _TINY_MT, _TINY_MT, a)
    s = o - v0
    u = f * dot(s, h)
    q = (o_r[0] - v0_r[0]) * e1_r[1] - (o_r[1] - v0_r[1]) * e1_r[0]  # cross(s, e1)
    v = f * dot(d, q)
    t = f * dot(e2, q)
    hit = ((abs_a >= constants.TRI_EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t > constants.TRI_EPS) & (t < t_max))
    return t, u, v, hit


def slab_aabb(o, rd, t_max, bmin, bmax):
    """Slab test of rays o [..., 3] with reciprocal directions rd against
    boxes [bmin, bmax] [..., 3]: (tmin, hit), hit iff tmax >= tmin,
    tmin < t_max and tmax > 0 (the reference's BVH_FASTER_RAY variant,
    infra/bvh.cpp:181-190).  minimum, maximum, amax and amin propagate
    NaN in torch as in jnp, and a NaN fails the test."""
    t1 = (bmin - o) * rd
    t2 = (bmax - o) * rd
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    return tmin, (tmax >= tmin) & (tmin < t_max) & (tmax > 0.0)


def _guard(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < _TINY, _TINY, x)


def plane(o, d, n, dist, t_max):
    """Infinite plane `dot(P, n) + dist = 0` (template/primitives.h:107-111).
    Returns (t, hit) with hit iff 0 < t < t_max."""
    denom = _guard(vm.dot(d, n))
    t = -(vm.dot(o, n) + dist) / denom
    return t, (t < t_max) & (t > 0.0)


def plane_uv(p, inv_texture_offset):
    """Floor UV for +Y planes (template/primitives.h:117-133):
    u = frac(x * invto), v = frac(z * invto)."""
    u = p[..., 0] * inv_texture_offset
    v = p[..., 2] * inv_texture_offset
    return torch.stack([u - torch.floor(u), v - torch.floor(v)], dim=-1)


def quad(o, d, inv_t, size, t_max):
    """Quad in its local XZ plane at y = 0, half-extent `size`
    (template/primitives.h:321-345); `inv_t` is its inverse transform
    [4, 4], row-major.  Returns (t, hit)."""
    ox_, oy_, oz_ = o[..., 0], o[..., 1], o[..., 2]
    dx_, dy_, dz_ = d[..., 0], d[..., 1], d[..., 2]

    def row_pos(i):
        return ox_ * inv_t[i, 0] + oy_ * inv_t[i, 1] + oz_ * inv_t[i, 2] + inv_t[i, 3]

    def row_dir(i):
        return dx_ * inv_t[i, 0] + dy_ * inv_t[i, 1] + dz_ * inv_t[i, 2]

    t = row_pos(1) / -_guard(row_dir(1))
    ix = row_pos(0) + t * row_dir(0)
    iz = row_pos(2) + t * row_dir(2)
    hit = (t < t_max) & (t > 0.0) & (ix > -size) & (ix < size) & (iz > -size) & (iz < size)
    return t, hit


def primitive_hits(scene, o: torch.Tensor, d: torch.Tensor):
    """Nearest of the scene's light quad (object 0) and floor plane
    (object 1): (t [R], obj [R]), t = RAY_FAR and obj = -1 where both miss."""
    r = o.shape[0]
    t = torch.full((r,), constants.RAY_FAR, dtype=torch.float32, device=o.device)
    obj = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    lt, lhit = quad(o, d, scene.light_inv_t, scene.light_size, t)
    t = torch.where(lhit, lt, t)
    obj = torch.where(lhit, 0, obj)
    floor_n = torch.as_tensor(FLOOR_NORMAL, device=o.device)
    ft, fhit = plane(o, d, floor_n, FLOOR_D, t)
    return torch.where(fhit, ft, t), torch.where(fhit, 1, obj)


def light_pos(light_t: torch.Tensor) -> torch.Tensor:
    """The point light: the middle of the light quad's corners (-0.5, 0,
    -0.5) and (0.5, 0, 0.5) moved by `light_t`, minus 0.01 in y
    (tlas_file_scene.cpp:191-196).  float32 [3]."""

    def corner(x, z):
        return light_t[:3, 0] * x + light_t[:3, 1] * 0.0 + light_t[:3, 2] * z + light_t[:3, 3]

    dy = torch.tensor([0.0, 0.01, 0.0], dtype=torch.float32, device=light_t.device)
    return (corner(-0.5, -0.5) + corner(0.5, 0.5)) * 0.5 - dy
