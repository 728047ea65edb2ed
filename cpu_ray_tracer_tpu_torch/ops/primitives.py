"""Batched analytic primitives of the reference's primitive scene: sphere,
oriented cube and torus (template/primitives.h), as the JAX package's
`cpu_ray_tracer_tpu/ops/primitives.py`, in its float32 operation order.
The quad and the infinite plane are in `ops/intersect.py`.

Each intersector takes rays (o, d) [R, 3] and t_max [R] and returns
(t, hit): t where hit (0 < t < t_max), else t_max.  No kernel runs here:
a few dozen elementwise operations a ray (the torus about 150), the same
on the CPU and the card up to the last bit of `acos`, `cos` and the cube
root, whose float32 rounding the primitive scene's torus solve in float64
keeps from deciding a hit.
"""

from __future__ import annotations

import torch

from cpu_ray_tracer_tpu_torch.core import vecmath as vm

_THIRD = 0.33333333333
_BIG = 1e20
_CUBE_NORMALS = ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))


def _guard(x: torch.Tensor, tiny: float) -> torch.Tensor:
    """x, or `tiny` (rounded to x's dtype) where |x| < tiny."""
    tiny = torch.tensor(tiny, dtype=x.dtype, device=x.device)
    return torch.where(x.abs() < tiny, tiny, x)


def sphere(o, d, pos, r2, t_max):
    """Sphere with inside hits (primitives.h:37-59): the near root, or for
    an origin inside (c <= 0) the far root."""
    oc = o - pos
    b = vm.dot(oc, d)
    c = vm.dot(oc, oc) - r2
    disc = b * b - c
    valid = disc > 0.0
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t_near = -b - sq
    t_far = sq - b
    near_ok = valid & (t_near > 0.0) & (t_near < t_max)
    far_ok = valid & ~near_ok & (c <= 0.0) & (t_far > 0.0) & (t_far < t_max)
    t = torch.where(near_ok, t_near, torch.where(far_ok, t_far, t_max))
    return t, near_ok | far_ok


def sphere_normal(p, pos, inv_r):
    return (p - pos) * inv_r


def cube(o, d, inv_m, bmin, bmax, t_max):
    """Oriented box (primitives.h:199-253): the ray in object space, the
    slab test; the near hit, or the far hit from inside."""
    oo = vm.transform_position(o, inv_m)
    od = vm.transform_vector(d, inv_m)
    rd = 1.0 / od
    t1 = (bmin - oo) * rd
    t2 = (bmax - oo) * rd
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    ok = tmin < tmax
    near_ok = ok & (tmin > 0.0) & (tmin < t_max)
    far_ok = ok & ~(tmin > 0.0) & (tmax > 0.0) & (tmax < t_max)
    t = torch.where(near_ok, tmin, torch.where(far_ok, tmax, t_max))
    return t, near_ok | far_ok


def cube_normal(p, m, inv_m, bmin, bmax):
    """The normal of the nearest face in object space, rotated to world
    (primitives.h:286-303)."""
    op = vm.transform_position(p, inv_m)
    dist = torch.stack([(op[:, 0] - bmin[0]).abs(), (op[:, 0] - bmax[0]).abs(),
                        (op[:, 1] - bmin[1]).abs(), (op[:, 1] - bmax[1]).abs(),
                        (op[:, 2] - bmin[2]).abs(), (op[:, 2] - bmax[2]).abs()], dim=-1)
    normals = torch.tensor(_CUBE_NORMALS, dtype=torch.float32, device=p.device)
    return vm.transform_vector(normals[torch.argmin(dist, dim=-1)], m)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root (PyTorch has none): sign(x) |x|^(1/3)."""
    return torch.sign(x) * torch.pow(x.abs(), 1.0 / 3.0)


def torus(o, d, inv_t, rc2, rt2, r2, t_max, newton_iters: int = 2):
    """Torus about the object-space z axis, Quilez's quartic
    (primitives.h:389-470), in the dtype of the inputs, the root polished
    by Newton steps on the quartic as in the JAX package.  The reference
    solves in double; the JAX package solves in float32, a TPU's widest
    float (`scene/primitive_scene.py` picks the precision)."""
    oo = vm.transform_position(o, inv_t)
    od = vm.transform_vector(d, inv_t)
    m = vm.dot(oo, oo)
    k3 = vm.dot(oo, od)
    k32 = k3 * k3
    bound = k32 - m + r2 >= 0.0  # the bounding sphere

    k = (m - rt2 - rc2) * 0.5
    k2 = k32 + rc2 * od[:, 2] * od[:, 2] + k
    k1 = k * k3 + rc2 * oo[:, 2] * od[:, 2]
    k0 = k * k + rc2 * oo[:, 2] * oo[:, 2] - rc2 * rt2

    # the double-root guard (po flip), branchless
    flip = (k3 * (k32 - k2) + k1).abs() < 1e-4
    k0_safe = _guard(k0, 1e-20)
    k1f = torch.where(flip, k3, k1)
    k3f = torch.where(flip, k1, k3)
    inv_k0 = 1.0 / k0_safe
    k1n = torch.where(flip, k1f * inv_k0, k1f)
    k2n = torch.where(flip, k2 * inv_k0, k2)
    k3n = torch.where(flip, k3f * inv_k0, k3f)
    k32n = k3n * k3n
    po = torch.where(flip, -1.0, 1.0)

    c2 = (2.0 * k2n - 3.0 * k32n) * _THIRD
    c1 = (k3n * (k32n - k2n) + k1n) * 2.0
    # the flipped branch forms c0 from 1/k0 (primitives.h:407-410)
    k0n = torch.where(flip, inv_k0, k0)
    c0 = (k3n * (k3n * (-3.0 * k32n + 4.0 * k2n) - 8.0 * k1n) + 4.0 * k0n) * _THIRD

    q = c2 * c2 + c0
    r_ = 3.0 * c0 * c2 - c2 * c2 * c2 - c1 * c1
    h = r_ * r_ - q * q * q
    sq_q = torch.sqrt(torch.clamp_min(q, 1e-30))
    z_trig = 2.0 * sq_q * torch.cos(
        torch.acos(torch.clamp(r_ / torch.clamp_min(sq_q * q, 1e-30), -1.0, 1.0)) * _THIRD)
    s_cbrt = _cbrt(torch.sqrt(torch.clamp_min(h, 0.0)) + r_.abs())
    z_card = torch.sign(r_) * (s_cbrt + q / _guard(s_cbrt, 1e-30)).abs()
    z = c2 - torch.where(h < 0.0, z_trig, z_card)

    d1 = z - 3.0 * c2
    d2 = z * z - 3.0 * c0
    small_d1 = d1.abs() < 1e-8
    d2_a = torch.sqrt(torch.clamp_min(d2, 0.0))
    d1_b = torch.sqrt(torch.clamp_min(d1 * 0.5, 1e-30))
    d2_b = c1 / d1_b
    ok_branch = torch.where(small_d1, d2 >= 0.0, d1 >= 0.0)
    d1v = torch.where(small_d1, 0.0, d1_b)
    d2v = torch.where(small_d1, d2_a, d2_b)

    def roots(sign: float):
        hh = d1v * d1v - z + sign * d2v
        valid = hh > 0.0
        sh = torch.sqrt(torch.clamp_min(hh, 0.0))
        base = -d1v if sign > 0 else d1v
        t1 = base - sh - k3n
        t2 = base + sh - k3n
        t1 = torch.where(po < 0, 2.0 / _guard(t1, 1e-20), t1)
        t2 = torch.where(po < 0, 2.0 / _guard(t2, 1e-20), t2)
        t1 = torch.where(valid & (t1 > 0.0), t1, _BIG)
        t2 = torch.where(valid & (t2 > 0.0), t2, _BIG)
        return torch.minimum(t1, t2)

    t = torch.minimum(roots(1.0), roots(-1.0))

    # Newton steps on the implicit torus along the ray
    def point(tv):
        return oo + tv[:, None] * od

    for _ in range(newton_iters):
        p = point(t)
        s = vm.dot(p, p) + rc2 - rt2
        f = s * s - 4.0 * rc2 * (p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1])
        ds = 2.0 * vm.dot(p, od)
        fp = 2.0 * s * ds - 8.0 * rc2 * (p[:, 0] * od[:, 0] + p[:, 1] * od[:, 1])
        t = t - f / _guard(fp, 1e-12)

    hit = bound & ok_branch & (t > 0.0) & (t < t_max) & (t < 1e19)
    return torch.where(hit, t, t_max), hit


def torus_normal(p, t_mat, inv_t, rc2, rt2):
    """normalize(L (L.L - rt2 - rc2 (1, 1, -1))) in object space, rotated to
    world (primitives.h:528-533)."""
    lp = vm.transform_position(p, inv_t)
    s = vm.dot(lp, lp)[:, None]
    factor = s - rt2 - rc2 * torch.tensor([1.0, 1.0, -1.0], dtype=torch.float32, device=p.device)
    return vm.transform_vector(vm.normalize(lp * factor), t_mat)
