"""What `--seed` makes: the camera views, and the draws of the check.

The camera is `bench.py`'s (pos (0, 0.3, -1.2), target (0, -0.1, 2.5))
moved along a small orbit about its target: at phase phi it turns by
yaw_deg cos(phi) about the vertical through the target and rises by
lift sin(phi).  A cell's mix fixes yaw_deg and lift; the seed fixes the
phase (uniform in [0, 2 pi), or which of the mix's evenly spaced views
comes first) and, through a second stream, every draw of the check.
Every seed gives the same sizes and the same kind of view, so seeds
change where the rays go and not how many are asked for.
"""

from __future__ import annotations

import math

import numpy as np

BASE_POS = (0.0, 0.3, -1.2)
TARGET = (0.0, -0.1, 2.5)


def streams(seed: int):
    """(the inputs' generator, the check's generator) of `seed`, any whole
    number."""
    root = np.random.SeedSequence(int(seed) % (1 << 64))
    a, b = root.spawn(2)
    return np.random.default_rng(a), np.random.default_rng(b)


def orbit(phase: float, yaw_deg: float, lift: float):
    """(pos, target) as float32 tuples: the camera at `phase` on the orbit
    (module docstring)."""
    target = np.asarray(TARGET, np.float64)
    r = np.asarray(BASE_POS, np.float64) - target
    a = math.radians(yaw_deg) * math.cos(phase)
    c, s = math.cos(a), math.sin(a)
    r = np.array([c * r[0] + s * r[2], r[1] + lift * math.sin(phase), -s * r[0] + c * r[2]])
    pos = (target + r).astype(np.float32)
    return tuple(float(x) for x in pos), tuple(float(x) for x in target.astype(np.float32))
