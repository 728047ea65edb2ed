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

The probe renders through a radiance function `radiance(o, d, seeds) ->
[R, 3]` of the integrator under test, for instance
`lambda o, d, s: pathtracer.sample_radiance(scene, o, d, s)[0]`; `seeds`
may be None for an integrator without random numbers.

Gradients of two renders compare on the pixels where the images agree
(`agreement_mask`): a borderline pixel's path differs, and so does its
gradient.
"""

from __future__ import annotations

import torch

from cpu_ray_tracer_tpu_torch.core import vecmath as vm


def nudge_sensitive(radiance, o, d, seeds, eps: float = 1e-6,
                    atol: float = 2e-5, rtol: float = 1e-4) -> torch.Tensor:
    """Bool [P] on the CPU: whether the radiance along rays (o, d) [P, 3]
    (with `seeds` [P] or None) changes beyond (atol, rtol) under an `eps`
    nudge of the rays."""
    base = radiance(o, d, seeds)
    nudges = [(o + d * eps, d)]
    for axis in range(3):
        for sign in (1.0, -1.0):
            tilt = torch.zeros_like(d)
            tilt[:, axis] = sign * eps
            nudges.append((o, vm.normalize(d + tilt)))
    moved = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for oo, dd in nudges:
        rad = radiance(oo.contiguous(), dd.contiguous(), seeds)
        moved |= ~torch.isclose(rad, base, atol=atol, rtol=rtol).all(dim=-1)
    return moved.cpu()


def unexplained_pixels(radiance, rays, img, ref, atol: float = 2e-5,
                       rtol: float = 1e-4) -> dict:
    """Compare `img` with `ref` ([H, W, 3], CPU tensors) at (atol, rtol).
    `rays` = (o, d, seeds) are the frame's camera rays in scanline order
    (seeds may be None).  Returns the flat indices of the pixels beyond
    tolerance (`bad`) and of those among them that the nudge probe,
    rendering through `radiance`, does not show to be borderline
    (`unexplained`: each is a real disagreement)."""
    bad = torch.nonzero(
        ~torch.isclose(img, ref, atol=atol, rtol=rtol).all(dim=-1).reshape(-1)
    ).squeeze(1)
    if bad.numel() == 0:
        return dict(bad=bad, unexplained=bad)
    o, d, seeds = rays
    idx = bad.to(o.device)
    sensitive = nudge_sensitive(
        radiance, o[idx], d[idx], None if seeds is None else seeds[idx], atol=atol, rtol=rtol,
    )
    return dict(bad=bad, unexplained=bad[~sensitive])


def agreement_mask(radiance, rays, img, ref, atol: float = 2e-5,
                   rtol: float = 1e-4) -> tuple[torch.Tensor, dict]:
    """`unexplained_pixels` of `img` against `ref`, and a float32 mask
    [H, W, 1] on the CPU that is 0 on the pixels beyond tolerance and 1
    elsewhere: a loss weighted by it compares two renders' gradients over
    the pixels whose paths agree."""
    cmp = unexplained_pixels(radiance, rays, img, ref, atol, rtol)
    mask = torch.ones(img.shape[0] * img.shape[1], dtype=torch.float32)
    mask[cmp["bad"]] = 0.0
    return mask.reshape(img.shape[0], img.shape[1], 1), cmp
