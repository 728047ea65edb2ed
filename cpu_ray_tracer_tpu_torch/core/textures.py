"""Texture atlas and its two taps, as the JAX package's
`cpu_ray_tracer_tpu/core/textures.py`.

All of a scene's textures (material maps, the floor, the skydome) share one
texel buffer with a per-texture (offset, width, height) table.  Two taps:

* nearest: reads the packed `0x00RRGGBB` word of a texel (the reference's
  own pixel format, texture.h:35) and keeps the reference's truncation
  (texture.h:61-96); it carries no gradient to the texels;
* bilinear (a scene compiled with `bilinear=True`): four taps of the float
  texels with clamp-to-edge and texel centres at (i + 0.5) / w,
  differentiable in the texels and in uv.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

INV_255 = np.float32(1.0 / 255.0)


@dataclasses.dataclass
class Atlas:
    """Host-side atlas; `scene.types.DeviceScene` holds it as buffers."""

    texels: np.ndarray  # float32 [K, 3], all textures row-major
    packed: np.ndarray  # int32 [K] 0x00RRGGBB
    offset: np.ndarray  # int32 [T]
    width: np.ndarray  # int32 [T]
    height: np.ndarray  # int32 [T]


def build_atlas(images: list[np.ndarray]) -> Atlas:
    """Pack HxWx3 float32 images into one atlas (JAX `build_atlas`)."""
    if not images:
        images = [np.zeros((1, 1, 3), np.float32)]
    offsets, widths, heights, bufs = [], [], [], []
    off = 0
    for img in images:
        h, w = img.shape[:2]
        offsets.append(off)
        widths.append(w)
        heights.append(h)
        bufs.append(np.asarray(img, np.float32).reshape(h * w, 3))
        off += h * w
    texels = np.concatenate(bufs, axis=0)
    u8 = np.clip(np.round(texels * 255.0), 0, 255).astype(np.int32)
    packed = (u8[:, 0] << 16) | (u8[:, 1] << 8) | u8[:, 2]
    return Atlas(
        texels=texels,
        packed=packed.astype(np.int32),
        offset=np.asarray(offsets, np.int32),
        width=np.asarray(widths, np.int32),
        height=np.asarray(heights, np.int32),
    )


def nearest_texel(packed: torch.Tensor, off, w, h, u, v) -> torch.Tensor:
    """Nearest-texel fetch for per-ray (or scalar) offset/width/height:
    u clamped to [0, 1], v flipped then clamped, truncated to a texel,
    clamped to the edge (texture.h:61-96).  Returns float32 [N, 3]."""
    uu = torch.clamp(u, 0.0, 1.0)
    vv = 1.0 - torch.clamp(v, 0.0, 1.0)
    x = torch.minimum(torch.clamp_min((uu * w.to(torch.float32)).to(torch.int32), 0), w - 1)
    y = torch.minimum(torch.clamp_min((vv * h.to(torch.float32)).to(torch.int32), 0), h - 1)
    return unpack_rgb(packed[(off + x + y * w).long()])


def sample_bilinear(texels: torch.Tensor, off, w, h, u, v) -> torch.Tensor:
    """Bilinear fetch from the float atlas `texels` [K, 3] for per-ray (or
    scalar) offset/width/height: u clamped to [0, 1], v flipped then
    clamped, four taps clamped to the edge, lerped in x then in y (the JAX
    package's `sample_bilinear`, same float32 operation order).  The taps
    are `index_select`s, whose backward adds into the texels with atomics
    (an index's backward sorts and serializes the rays that share a
    texel).  Returns float32 [N, 3]."""
    uu = torch.clamp(u, 0.0, 1.0)
    vv = 1.0 - torch.clamp(v, 0.0, 1.0)
    fx = uu * w.to(torch.float32) - 0.5
    fy = vv * h.to(torch.float32) - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[:, None]
    ty = (fy - y0)[:, None]
    x0i, y0i = x0.to(torch.int32), y0.to(torch.int32)

    def edge(i, n):
        return torch.minimum(torch.clamp_min(i, 0), n - 1)

    xa, xb = edge(x0i, w), edge(x0i + 1, w)
    ya, yb = edge(y0i, h), edge(y0i + 1, h)

    def tap(x, y):
        return texels.index_select(0, (off + x + y * w).long().reshape(-1))

    top = tap(xa, ya) * (1 - tx) + tap(xb, ya) * tx
    bot = tap(xa, yb) * (1 - tx) + tap(xb, yb) * tx
    return top * (1 - ty) + bot * ty


def unpack_rgb(p: torch.Tensor) -> torch.Tensor:
    """float32 [N, 3] in [0, 1] of packed `0x00RRGGBB` texels [N]."""
    rgb = torch.stack([(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF], dim=-1)
    return rgb.to(torch.float32) * INV_255


def sample_equirect(scene, d: torch.Tensor, bilinear: bool = False) -> torch.Tensor:
    """Equirectangular skydome lookup from unit directions [N, 3]
    (tlas_file_scene.cpp:176-188): phi = atan2(-z, x) + pi,
    theta = acos(-y), u = phi/2pi, v = theta/pi; the nearest or the
    bilinear tap."""
    phi = torch.atan2(-d[..., 2], d[..., 0]) + np.float32(np.pi)
    theta = torch.acos(torch.clamp(-d[..., 1], -1.0, 1.0))
    u = phi * np.float32(0.5 / np.pi)
    v = theta * np.float32(1.0 / np.pi)
    tid = scene.skydome_tex
    off, w, h = scene.atlas_offset[tid], scene.atlas_width[tid], scene.atlas_height[tid]
    if bilinear:
        return sample_bilinear(scene.atlas_texels, off, w, h, u, v)
    return nearest_texel(scene.atlas_packed, off, w, h, u, v)
