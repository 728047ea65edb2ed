"""Fractal value noise, as the JAX package's `cpu_ray_tracer_tpu/core/noise.py`
(the reference's noise2D, template/tmplmath.cpp:36-88: part of the
template's math library, which its renderers do not call).  The lattice
hash wraps in int32 as the reference's 32-bit ints do; torch's int32
products and shifts wrap alike, on the CPU and on the card.

The interpolation's cosine is `_cosf`: the GNU C library's float32 `cos`
(its sincosf polynomials and table, `sysdeps/ieee754/flt-32/s_cosf.c`),
which XLA on the CPU calls, evaluated in float64 as there.  torch's own
float32 `cos` differs from it in the last bit, and from the card's; this
one is the JAX package's bit for bit on the CPU and the same on the card
(float64 products and sums round alike on both)."""

from __future__ import annotations

import numpy as np
import torch

_PRIMES = (
    (995615039, 600173719, 701464987),
    (831731269, 162318869, 136250887),
    (174329291, 946737083, 245679977),
    (362489573, 795918041, 350777237),
    (457025711, 880830799, 909678923),
    (787070341, 177340217, 593320781),
    (405493717, 291031019, 391950901),
    (458904767, 676625681, 424452397),
    (531736441, 939683957, 810651871),
    (997169939, 842027887, 423882827),
)
_PI = np.float32(np.pi)
# glibc's __sincosf_table[0]: 2/pi scaled by 2^24, pi/2, the cosine's
# coefficients c0..c4 and the sine's s1..s3 (table 1 negates c0..c4)
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")
_HPI = float.fromhex("0x1.921fb54442d18p+0")
_C = tuple(float.fromhex(h) for h in ("0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
                                     "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_S = tuple(float.fromhex(h) for h in ("-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
                                     "-0x1.994eb3774cf24p-13"))


def _cosf(y: torch.Tensor) -> torch.Tensor:
    """cos of float32 y with |y| < 120 (noise2d passes [0, pi)), as glibc's
    `cosf`: below |y| of about 0.75 the cosine polynomial of y; above, y
    less the nearest multiple n of pi/2 into the sine or cosine polynomial
    of quadrant n; 1 below about 2^-12; all in float64, rounded once."""
    x = y.to(torch.float64)
    top = (y.view(torch.int32) >> 20) & 0x7FF  # glibc's abstop12
    small = top < 0x3F4
    n = torch.where(small, 0, ((x * _HPI_INV).to(torch.int64) + 0x800000) >> 24)
    xr = torch.where(small, x, x - n.to(torch.float64) * _HPI)
    x2 = xr * xr
    # the sine's argument carries the quadrant's sign; quadrants 2 and 3
    # take table 1, whose cosine coefficients are negated
    xs = torch.where(((n & 3) == 1) | ((n & 3) == 2), -xr, xr)
    flip = torch.where((n & 2) != 0, -1.0, 1.0).to(torch.float64)
    c0, c1, c2, c3, c4 = (c * flip for c in _C)
    x4 = x2 * x2
    cos_poly = ((c0 + x2 * c1) + x4 * c2) + (x4 * x2) * (c3 + x2 * c4)
    x3 = xs * x2
    sin_poly = (xs + x3 * _S[0]) + (x3 * x2) * (_S[1] + x2 * _S[2])
    out = torch.where((n & 1) == 1, sin_poly, cos_poly)
    return torch.where(top < 0x398, 1.0, out).to(torch.float32)


def _noise(x: torch.Tensor, y: torch.Tensor, prime_index: int) -> torch.Tensor:
    """Integer-lattice hash noise in [-1, 1] (tmplmath.cpp Noise2D)."""
    n = x.to(torch.int32) + y.to(torch.int32) * 57
    n = (n << 13) ^ n
    a, b, c = _PRIMES[prime_index % len(_PRIMES)]
    t = (n * (n * n * a + b) + c) & 0x7FFFFFFF
    return 1.0 - t.to(torch.float32) / np.float32(1073741824.0)


def _smoothed(x, y, i):
    corners = (_noise(x - 1, y - 1, i) + _noise(x + 1, y - 1, i)
               + _noise(x - 1, y + 1, i) + _noise(x + 1, y + 1, i)) / 16.0
    sides = (_noise(x - 1, y, i) + _noise(x + 1, y, i)
             + _noise(x, y - 1, i) + _noise(x, y + 1, i)) / 8.0
    return corners + sides + _noise(x, y, i) / 4.0


def _cosine(a, b, t):
    f = (1.0 - _cosf(t * _PI)) * 0.5
    return a * (1 - f) + b * f


def _interpolated(x, y, i):
    xi, yi = torch.floor(x), torch.floor(y)
    fx, fy = x - xi, y - yi
    v1 = _smoothed(xi, yi, i)
    v2 = _smoothed(xi + 1, yi, i)
    v3 = _smoothed(xi, yi + 1, i)
    v4 = _smoothed(xi + 1, yi + 1, i)
    return _cosine(_cosine(v1, v2, fx), _cosine(v3, v4, fx), fy)


def noise2d(x: torch.Tensor, y: torch.Tensor, octaves: int = 7,
            persistence: float = 0.5) -> torch.Tensor:
    """Fractal value noise at float32 points (x, y), the reference's octave
    sum: frequency doubling, amplitude times `persistence`."""
    x, y = x.to(torch.float32), y.to(torch.float32)
    total = torch.zeros_like(x)
    freq, amp = 1.0, 1.0
    for i in range(octaves):
        total = total + _interpolated(x * freq, y * freq, i) * amp
        freq *= 2.0
        amp *= persistence
    return total
