"""Texture atlas and nearest-texel sampling, as the JAX package's
`cpu_ray_tracer_tpu/core/textures.py`.

All of a scene's textures (material maps, the floor, the skydome) share one
texel buffer with a per-texture (offset, width, height) table.  Nearest
taps read the packed `0x00RRGGBB` word of a texel (the reference's own
pixel format, texture.h:35) and keep the reference's truncation
(texture.h:61-96).
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


def unpack_rgb(p: torch.Tensor) -> torch.Tensor:
    """float32 [N, 3] in [0, 1] of packed `0x00RRGGBB` texels [N]."""
    rgb = torch.stack([(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF], dim=-1)
    return rgb.to(torch.float32) * INV_255


def sample_equirect(scene, d: torch.Tensor) -> torch.Tensor:
    """Equirectangular skydome lookup from unit directions [N, 3]
    (tlas_file_scene.cpp:176-188): phi = atan2(-z, x) + pi,
    theta = acos(-y), u = phi/2pi, v = theta/pi."""
    phi = torch.atan2(-d[..., 2], d[..., 0]) + np.float32(np.pi)
    theta = torch.acos(torch.clamp(-d[..., 1], -1.0, 1.0))
    u = phi * np.float32(0.5 / np.pi)
    v = theta * np.float32(1.0 / np.pi)
    tid = scene.skydome_tex
    return nearest_texel(
        scene.atlas_packed, scene.atlas_offset[tid], scene.atlas_width[tid],
        scene.atlas_height[tid], u, v,
    )
