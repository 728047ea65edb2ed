"""Pinhole camera and batched primary-ray generation, as the JAX package's
`cpu_ray_tracer_tpu/core/camera.py:34-130` (template/camera.h:11-79): the
screen plane at `pos + 2*ahead`, half-height 1, half-width = aspect; a ray
through pixel coordinates (x, y) bilerps topLeft/topRight/bottomLeft by
(x/W, y/H).

`lane_order` gives the order in which the fused kernels take a frame's
camera rays: a warp of 32 lanes takes an 8x4 tile of pixels rather than a
1x32 strip of a scanline, so that its rays walk the scene together."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch.core import device as device_mod
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


def pixel_grid(cam: Camera, device=device_mod.DEFAULT):
    """Flat (xs, ys) integer pixel centres in scanline order [W*H], float32,
    on `device` (the card unless the caller asks for another)."""
    device = device_mod.resolve(device)
    ys, xs = torch.meshgrid(
        torch.arange(cam.height, device=device),
        torch.arange(cam.width, device=device),
        indexing="ij",
    )
    return xs.reshape(-1).to(torch.float32), ys.reshape(-1).to(torch.float32)


def full_frame_rays(cam: Camera, jitter_x=None, jitter_y=None, device=device_mod.DEFAULT):
    """One ray per pixel in scanline order, optionally sub-pixel jittered
    (3. PathTracer/renderer.cpp:123-126), on `device`, or on the jitter's
    device where one is given."""
    if jitter_x is not None:
        device = jitter_x.device
    xs, ys = pixel_grid(cam, device)
    if jitter_x is not None:
        xs = xs + jitter_x
    if jitter_y is not None:
        ys = ys + jitter_y
    return primary_rays(cam, xs, ys)


TILE_W, TILE_H = 8, 4  # pixels of a warp's tile in `lane_order`


@functools.lru_cache(maxsize=16)
def _lane_order(width: int, height: int, device: torch.device) -> torch.Tensor:
    ys, xs = np.divmod(np.arange(width * height), width)
    tiles_x = -(-width // TILE_W)
    key = ((ys // TILE_H) * tiles_x + xs // TILE_W) * (TILE_W * TILE_H) \
        + (ys % TILE_H) * TILE_W + xs % TILE_W
    return torch.from_numpy(np.argsort(key, kind="stable").astype(np.int32)).to(device)


def lane_order(cam: Camera, device=device_mod.DEFAULT) -> torch.Tensor:
    """int32 [W*H], made once per camera size and device: entry j is the
    scanline index of the pixel whose ray lane j of a fused kernel takes
    (`ops/wavefront_pt.trace`, `ops/whitted_wf.trace_level0`).  The frame
    is cut into 8x4 tiles in scanline order of tiles, each tile's pixels in
    scanline order, so a warp of 32 lanes takes one tile; tiles at the
    right and bottom edges are narrower or shorter and share a warp with
    the next."""
    return _lane_order(cam.width, cam.height, device_mod.resolve(device))
