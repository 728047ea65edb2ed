"""Debug AOV colourings (infra/helper.h:104-128), as the JAX package's
`cpu_ray_tracer_tpu/render/debug.py`."""

from __future__ import annotations

import numpy as np
import torch

_ONE, _ZERO = np.float32(1.0), np.float32(0.0)
_MASK = 0xFFFFFFFF
_GOLDEN = 2654435761  # Knuth's multiplicative hash constant


def traverse_count_color(count: torch.Tensor, peak) -> torch.Tensor:
    """Green -> red heatmap of traversal counts (helper.h:104-120
    GetTraverseCountColor): ratio = count / peak, the low half lerps green
    to yellow, the high half yellow to red."""
    peak = torch.as_tensor(peak, dtype=torch.float32, device=count.device)
    ratio = count.to(torch.float32) / torch.clamp_min(peak, 1.0)
    low = ratio <= 0.5
    t = torch.where(low, ratio * 2.0, (ratio - 0.5) * 2.0)
    r = torch.where(low, t, _ONE)
    g = torch.where(low, _ONE, 1.0 - t)
    return torch.stack([r, g, torch.zeros_like(r)], dim=-1)


def depth_color(depth: torch.Tensor, max_depth) -> torch.Tensor:
    """Blue -> red by tree depth (helper.h:122-128)."""
    peak = torch.as_tensor(max_depth, dtype=torch.float32, device=depth.device)
    ratio = depth.to(torch.float32) / torch.clamp_min(peak, 1.0)
    return torch.stack([ratio, torch.zeros_like(ratio), 1.0 - ratio], dim=-1)


def edge_color(bary: torch.Tensor) -> torch.Tensor:
    """Black near triangle edges (renderer.cpp GetEdgeDebugColor): bary
    [..., 2] holds (u, v)."""
    u, v = bary[..., 0], bary[..., 1]
    near = (u.abs() < 0.03) | ((u - 1.0).abs() < 0.03) | (v.abs() < 0.03) | ((v - 1.0).abs() < 0.03)
    c = torch.where(near, _ZERO, _ONE)
    return torch.stack([c, c, c], dim=-1)


def id_color(ids: torch.Tensor) -> torch.Tensor:
    """Stable pseudo-random colour per object id, black for misses: the
    uint32 hash (id + 1) * 2654435761, in int64 with the product split in
    two 16-bit halves of the constant so that no partial product passes
    2**48."""
    x = ((ids.to(torch.int64) & _MASK) + 1) & _MASK
    h = (x * (_GOLDEN & 0xFFFF) + (((x * (_GOLDEN >> 16)) & 0xFFFF) << 16)) & _MASK
    r = ((h >> 16) & 0xFF).to(torch.float32) / 255.0
    g = ((h >> 8) & 0xFF).to(torch.float32) / 255.0
    b = (h & 0xFF).to(torch.float32) / 255.0
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.where((ids >= 0)[..., None], rgb, _ZERO)
