"""Counter-based per-ray random numbers, bit-exact with the JAX package's
`cpu_ray_tracer_tpu/core/rng.py:24-75`: WangHash seeding and xorshift32
steps of the reference (template/tmplmath.cpp:3-34).

PyTorch on the CPU has no uint32 shifts or adds, so a seed is carried as an
int64 tensor holding the uint32 value, masked back to 32 bits after every
operation that can overflow.  Every product stays below 2**62.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
UINT_TO_FLOAT = np.float32(2.3283064365387e-10)  # 1/2^32, tmplmath.cpp:25


def wang_hash(s: torch.Tensor) -> torch.Tensor:
    """WangHash (template/tmplmath.cpp:5-12) on uint32 values in int64."""
    s = (s ^ 61) ^ (s >> 16)
    s = (s * 9) & MASK
    s = s ^ (s >> 4)
    s = (s * 0x27D4EB2D) & MASK
    return s ^ (s >> 15)


def init_seed(seed_base: torch.Tensor) -> torch.Tensor:
    """InitSeed (template/tmplmath.cpp:13-16): WangHash((seedBase+1)*17)."""
    return wang_hash(((seed_base + 1) * 17) & MASK)


def xorshift32(s: torch.Tensor) -> torch.Tensor:
    """One xorshift32 step (template/tmplmath.cpp:17-23)."""
    s = s ^ ((s << 13) & MASK)
    s = s ^ (s >> 17)
    return s ^ ((s << 5) & MASK)


def random_float(state: torch.Tensor):
    """Returns (new_state, float32 in [0, 1)): the uint32 rounded to the
    nearest float32, times 2.3283064365387e-10, as RandomFloat
    (tmplmath.cpp:25)."""
    s = xorshift32(state)
    return s, s.to(torch.float32) * UINT_TO_FLOAT


def pixel_seeds(pixel_ids: torch.Tensor, spp, salt: int = 1799) -> torch.Tensor:
    """Per-ray seeds keyed by (pixel, sample index): InitSeed(pixel + salt *
    spp), all in uint32 arithmetic.  `spp` is an int, or an integer tensor
    of per-ray sample indices (a megapass salts sample k of a pixel with
    spp_index + k)."""
    spp = torch.as_tensor(spp, dtype=torch.int64, device=pixel_ids.device) & MASK
    return init_seed((pixel_ids.to(torch.int64) + salt * spp) & MASK)
