"""Shading pieces of both integrators, as the JAX package's
`cpu_ray_tracer_tpu/render/common.py` (same float32 operation order)."""

from __future__ import annotations

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch import constants
from cpu_ray_tracer_tpu_torch.core import vecmath as vm
from cpu_ray_tracer_tpu_torch.scene import query

EPS = constants.SHADE_EPS


def direct_illumination(scene, point: torch.Tensor, normal: torch.Tensor, active=None):
    """Point-light irradiance [R, 3] with a shadow ray
    (2. WhittedStyle/renderer.cpp:105-126): inverse-square falloff, N.L,
    shadow distance dist - 2 EPS; zero where `active` [R] is False."""
    light_pos = query.get_light_pos(scene)
    l = light_pos - point
    dist = torch.sqrt((l * l).sum(dim=-1))
    l = l / torch.clamp_min(dist, np.float32(1e-20))[:, None]
    ndotl = vm.dot(normal, l)
    facing = ndotl >= EPS
    occ = query.is_occluded(
        scene, (point + l * EPS).contiguous(), l.contiguous(),
        torch.clamp_min(dist - np.float32(2.0) * EPS, np.float32(1e-6)), mask=active,
    )
    att = 1.0 / torch.clamp_min(dist * dist, np.float32(1e-20))
    irr = scene.light_color * (att * ndotl)[:, None]
    vis = facing & ~occ
    if active is not None:
        vis = vis & active
    return torch.where(vis[:, None], irr, np.float32(0.0))


def dielectric_terms(d: torch.Tensor, n: torch.Tensor, inside: torch.Tensor):
    """Dielectric terms (3. PathTracer/renderer.cpp:27-45): Schlick
    Fresnel, whether refraction is possible, and the transmitted and
    reflected directions.  Fresnel is 1 under total internal reflection."""
    ins = inside[:, None]
    n1 = torch.where(ins, constants.IOR, np.float32(1.0))
    n2 = torch.where(ins, np.float32(1.0), constants.IOR)
    eta = n1 / n2
    cosi = ((-d) * n).sum(dim=-1, keepdim=True)
    cost2 = 1.0 - eta * eta * (1.0 - cosi * cosi)
    t_dir = eta * d + (eta * cosi - torch.sqrt(cost2.abs())) * n
    can = cost2 > 0.0
    # Schlick: R0 = ((n1-n2)/(n1+n2))^2, Fr = R0 + (1-R0)(1-cosi)^5
    a = n1 - n2
    b = n1 + n2
    r0 = (a * a) / (b * b)
    c = 1.0 - cosi
    schlick = r0 + (1.0 - r0) * (c * c * c * c * c)
    fr = torch.where(can, schlick, np.float32(1.0))
    return fr[:, 0], can[:, 0], t_dir, vm.reflect(d, n)


def orthonormal_basis(n: torch.Tensor):
    """Branchless tangent frame (Frisvad-style)."""
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    s = torch.where(nz >= 0.0, np.float32(1.0), np.float32(-1.0))
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], dim=-1)
    bt = torch.stack([b, s + ny * ny * a, ny * -1.0], dim=-1)
    return t, bt


def uniform_hemisphere(n: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor):
    """Uniform solid-angle direction about n (pdf 1/2pi), paired with the
    estimator brdf * 2pi * cos (3. PathTracer/renderer.cpp:93-99)."""
    z = r1
    phi = constants.TWO_PI * r2
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    t, bt = orthonormal_basis(n)
    return t * x[:, None] + bt * y[:, None] + n * z[:, None]
