"""Film: float32 radiance accumulation and display conversion, as the JAX
package's `cpu_ray_tracer_tpu/core/film.py`: the reference's `Surface`
framebuffer and `float4* accumulator` (template/surface.h,
3. PathTracer/renderer.cpp:8-17) as an accumulator [H, W, 3] on the device
with the count of samples in it, so progressive rendering and
checkpoint/resume are plain arithmetic.  A frame goes to a PNG file through
`io/image.write_png`."""

from __future__ import annotations

import dataclasses

import torch

from cpu_ray_tracer_tpu_torch.core import device as device_mod


@dataclasses.dataclass
class Film:
    accum: torch.Tensor  # [H, W, 3] float32 radiance sum
    spp: int  # samples accumulated so far

    @property
    def shape(self):
        return self.accum.shape

    def mean(self) -> torch.Tensor:
        return self.accum / float(max(self.spp, 1))


def make_film(height: int, width: int, device=device_mod.DEFAULT) -> Film:
    """An empty film on `device` (the card unless the caller asks for
    another)."""
    accum = torch.zeros((height, width, 3), dtype=torch.float32,
                        device=device_mod.resolve(device))
    return Film(accum=accum, spp=0)


def add_samples(film: Film, radiance: torch.Tensor, n_samples: int) -> Film:
    """`film` with `radiance` [H, W, 3], the sum of `n_samples` samples a
    pixel, added."""
    return Film(accum=film.accum + radiance, spp=film.spp + n_samples)


def to_rgb8(img: torch.Tensor) -> torch.Tensor:
    """RGBF32_to_RGB8 (template/precomp.h:325-341): each channel clamped to
    [0, 1], times 255, truncated to uint8."""
    return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)


def energy(img: torch.Tensor) -> torch.Tensor:
    """The path tracer's 'energy' metric: the sum of every pixel's RGB
    values of the averaged film (3. PathTracer/renderer.cpp:155-157)."""
    return img.sum()
