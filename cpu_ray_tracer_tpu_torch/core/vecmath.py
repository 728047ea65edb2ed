"""Batched vector math on `[..., 3]` tensors, and the host-side (numpy)
matrix builders of the scene compiler — the subset of the JAX package's
`cpu_ray_tracer_tpu/core/vecmath.py` that the path tracer uses, with the
same float32 operation order."""

from __future__ import annotations

import numpy as np
import torch

EPS_NORMALIZE = np.float32(1e-20)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis."""
    return (a * b).sum(dim=-1)


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Safe normalize: a * rsqrt(max(|a|^2, 1e-20))."""
    sq = (a * a).sum(dim=-1, keepdim=True)
    return a * torch.rsqrt(torch.clamp_min(sq, EPS_NORMALIZE))


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection `i - 2*n*dot(n,i)` (template/tmplmath.h:506)."""
    return i - 2.0 * n * (n * i).sum(dim=-1, keepdim=True)


# Row-major 4x4 matrices like the reference's mat4 (template/tmplmath.h:639+):
# world = M @ [p; 1].  These run in the scene compiler only.


def mat_translate(v) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 3], m[1, 3], m[2, 3] = v
    return m


def mat_scale(v) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def mat_rotate_x(a: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    ca, sa = np.cos(a, dtype=np.float32), np.sin(a, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = ca, -sa, sa, ca
    return m


def mat_rotate_y(a: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    ca, sa = np.cos(a, dtype=np.float32), np.sin(a, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = ca, sa, -sa, ca
    return m


def mat_rotate_z(a: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    ca, sa = np.cos(a, dtype=np.float32), np.sin(a, dtype=np.float32)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = ca, -sa, sa, ca
    return m


def mat_inverted_no_scale(m: np.ndarray) -> np.ndarray:
    """Inverse of a rigid (rotation + translation) matrix, as
    mat4::FastInvertedTransformNoScale (template/tmplmath.h:808+)."""
    r = np.eye(4, dtype=np.float32)
    r[:3, :3] = m[:3, :3].T
    r[:3, 3] = -(m[:3, :3].T @ m[:3, 3])
    return r


def transform_vector(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The linear part of a row-major matrix `m` [4, 4] applied to vectors
    v [..., 3]: column by column, as the JAX package's `transform_vector`
    (template/tmplmath.h TransformVector)."""
    rot = m[:3, :3]
    return rot[:, 0] * v[..., 0:1] + rot[:, 1] * v[..., 1:2] + rot[:, 2] * v[..., 2:3]


def transform_position(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """`transform_vector` plus m's translation (TransformPosition)."""
    return transform_vector(p, m) + m[:3, 3]


def mat_inverted(m: np.ndarray) -> np.ndarray:
    """The full inverse of a 4x4 matrix, float32."""
    return np.linalg.inv(m).astype(np.float32)
