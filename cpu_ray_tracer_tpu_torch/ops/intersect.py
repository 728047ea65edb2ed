"""Closed-form quad and plane intersection and the floor's UV mapping, as
the JAX package's `cpu_ray_tracer_tpu/ops/intersect.py` (the reference's
template/primitives.h:100-179, :321-375): branchless, masks instead of
early returns, the same float32 operation order."""

from __future__ import annotations

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch import constants
from cpu_ray_tracer_tpu_torch.core import vecmath as vm

_TINY = np.float32(1e-20)
FLOOR_NORMAL = np.array([0.0, 1.0, 0.0], np.float32)
FLOOR_D = np.float32(1.0)


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
