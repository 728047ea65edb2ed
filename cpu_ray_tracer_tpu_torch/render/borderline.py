"""Floating-point borderline probe for comparing two renders.

Two implementations of the same estimator (this port on the CPU and on
the card, or the port and the JAX package) evaluate transcendental
functions and reductions with different last-bit rounding.  A path that
passes within a rounding error of an edge, a texel boundary or a lobe
threshold can then take another turn, and its pixel differs by far more
than the tolerance.  Such a pixel is legitimate only if it is borderline:
`nudge_sensitive` measures that, as the JAX package's
tests/test_instancing.py:57-70 does for hits, by re-rendering the pixel's
path with its camera ray nudged by `eps` (origin moved along the ray;
direction tilted toward each axis) and reporting whether any nudge moves
the pixel beyond the tolerance.
"""

from __future__ import annotations

import torch

from cpu_ray_tracer_tpu_torch import constants
from cpu_ray_tracer_tpu_torch.core import vecmath as vm
from cpu_ray_tracer_tpu_torch.render import pathtracer


def nudge_sensitive(
    scene, camera, spp_index: int, pixels: torch.Tensor,
    depth_limit: int = constants.DEPTH_LIMIT, eps: float = 1e-6,
    atol: float = 2e-5, rtol: float = 1e-4,
) -> torch.Tensor:
    """Bool [P] on the CPU: whether the paths of the flat pixel indices
    `pixels` change beyond (atol, rtol) under an `eps` nudge of their
    camera rays, rendered with `scene` as `render_pass` renders them."""
    o, d, seeds = pathtracer.camera_rays(camera, spp_index, scene.device)
    idx = pixels.to(scene.device).long()
    o, d, seeds = o[idx], d[idx], seeds[idx]
    base, _ = pathtracer.sample_radiance(scene, o, d, seeds, depth_limit)
    nudges = [(o + d * eps, d)]
    for axis in range(3):
        for sign in (1.0, -1.0):
            tilt = torch.zeros_like(d)
            tilt[:, axis] = sign * eps
            nudges.append((o, vm.normalize(d + tilt)))
    moved = torch.zeros(idx.shape[0], dtype=torch.bool, device=scene.device)
    for oo, dd in nudges:
        rad, _ = pathtracer.sample_radiance(scene, oo, dd, seeds, depth_limit)
        moved |= ~torch.isclose(rad, base, atol=atol, rtol=rtol).all(dim=-1)
    return moved.cpu()


def unexplained_pixels(scene, camera, spp_index: int, img, ref,
                       depth_limit: int = constants.DEPTH_LIMIT,
                       atol: float = 2e-5, rtol: float = 1e-4) -> dict:
    """Compare `img` with `ref` ([H, W, 3], CPU tensors) at (atol, rtol).
    Returns the flat indices of the pixels beyond tolerance (`bad`) and of
    those among them that the nudge probe, run on `scene`, does not show
    to be borderline (`unexplained`: each is a real disagreement)."""
    bad = torch.nonzero(
        ~torch.isclose(img, ref, atol=atol, rtol=rtol).all(dim=-1).reshape(-1)
    ).squeeze(1)
    if bad.numel() == 0:
        return dict(bad=bad, unexplained=bad)
    sensitive = nudge_sensitive(scene, camera, spp_index, bad, depth_limit, atol=atol, rtol=rtol)
    return dict(bad=bad, unexplained=bad[~sensitive])
