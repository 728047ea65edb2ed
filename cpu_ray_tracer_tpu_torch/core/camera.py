"""Pinhole camera and batched primary-ray generation, as the JAX package's
`cpu_ray_tracer_tpu/core/camera.py:34-130` (template/camera.h:11-79): the
screen plane at `pos + 2*ahead`, half-height 1, half-width = aspect; a ray
through pixel coordinates (x, y) bilerps topLeft/topRight/bottomLeft by
(x/W, y/H)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch.core import vecmath


@dataclasses.dataclass
class Camera:
    pos: np.ndarray  # float32 [3]
    target: np.ndarray  # float32 [3]
    top_left: np.ndarray  # float32 [3]
    top_right: np.ndarray  # float32 [3]
    bottom_left: np.ndarray  # float32 [3]
    width: int = 1024
    height: int = 640


def make_camera(width: int, height: int, pos=(0.0, 0.0, -2.0), target=(0.0, 0.0, -1.0)) -> Camera:
    """Camera from position and target (camera.h:61-73 SetCameraState)."""
    aspect = np.float32(width / height)
    pos = np.asarray(pos, np.float32)
    target = np.asarray(target, np.float32)
    ahead = target - pos
    ahead = ahead / np.linalg.norm(ahead)
    tmp_up = np.array([0.0, 1.0, 0.0], np.float32)
    right = np.cross(tmp_up, ahead)
    right = right / np.linalg.norm(right)
    up = np.cross(ahead, right)
    up = up / np.linalg.norm(up)
    right = np.cross(up, ahead)
    right = right / np.linalg.norm(right)
    return Camera(
        pos=pos,
        target=target,
        top_left=(pos + 2 * ahead - aspect * right + up).astype(np.float32),
        top_right=(pos + 2 * ahead + aspect * right + up).astype(np.float32),
        bottom_left=(pos + 2 * ahead - aspect * right - up).astype(np.float32),
        width=width,
        height=height,
    )


def primary_rays(cam: Camera, xs: torch.Tensor, ys: torch.Tensor):
    """Rays (o, d) [N, 3] through continuous pixel coordinates (xs, ys) [N]
    (camera.h:23-30): P = topLeft + u*(topRight-topLeft) +
    v*(bottomLeft-topLeft), D = normalize(P - camPos)."""

    def vec(a):
        return torch.as_tensor(a, dtype=torch.float32, device=xs.device)

    tl = vec(cam.top_left)
    u = (xs.to(torch.float32) / cam.width)[..., None]
    v = (ys.to(torch.float32) / cam.height)[..., None]
    p = tl + u * (vec(cam.top_right) - tl) + v * (vec(cam.bottom_left) - tl)
    pos = vec(cam.pos)
    d = vecmath.normalize(p - pos)
    return pos.expand_as(d).contiguous(), d


def pixel_grid(cam: Camera, device=None):
    """Flat (xs, ys) integer pixel centres in scanline order [W*H], float32."""
    ys, xs = torch.meshgrid(
        torch.arange(cam.height, device=device),
        torch.arange(cam.width, device=device),
        indexing="ij",
    )
    return xs.reshape(-1).to(torch.float32), ys.reshape(-1).to(torch.float32)


def full_frame_rays(cam: Camera, jitter_x=None, jitter_y=None, device=None):
    """One ray per pixel in scanline order, optionally sub-pixel jittered
    (3. PathTracer/renderer.cpp:123-126)."""
    if jitter_x is not None:
        device = jitter_x.device
    xs, ys = pixel_grid(cam, device)
    if jitter_x is not None:
        xs = xs + jitter_x
    if jitter_y is not None:
        ys = ys + jitter_y
    return primary_rays(cam, xs, ys)
