"""Checkpoint / resume of progressive renders, in the JAX package's `.npz`
format (`cpu_ray_tracer_tpu/utils/checkpoint.py`): `__version__` 1,
`accum` float32 [H, W, 3], `spp` int32 and `extra_<name>` arrays, written
to a temporary file and moved over the target, so that a film one package
writes loads in the other.  The reference's only resumable state, the
progressive accumulator and its sample count (3. PathTracer/
renderer.cpp:117-131,167), is never persisted there."""

from __future__ import annotations

import os

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch.core import device as device_mod
from cpu_ray_tracer_tpu_torch.core.film import Film

FORMAT_VERSION = 1


def save_film(path: str, film: Film, extra: dict | None = None) -> None:
    arrays = {
        "__version__": np.int64(FORMAT_VERSION),
        "accum": film.accum.detach().cpu().numpy(),
        "spp": np.asarray(film.spp, np.int32),
    }
    for k, v in (extra or {}).items():
        arrays["extra_" + k] = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    tmp = path + ".tmp.npz"  # np.savez appends .npz to a name without it
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_film(path: str, device=device_mod.DEFAULT) -> tuple[Film, dict]:
    """(film, extra) from `path`, the tensors on `device` (the card unless
    the caller asks for another)."""
    dev = device_mod.resolve(device)
    with np.load(path) as data:
        if int(data["__version__"]) != FORMAT_VERSION:
            raise ValueError(f"{path}: checkpoint format {int(data['__version__'])}, "
                             f"expected {FORMAT_VERSION}")
        film = Film(accum=torch.from_numpy(data["accum"]).to(dev), spp=int(data["spp"]))
        extra = {k[len("extra_"):]: torch.from_numpy(data[k]).to(dev)
                 for k in data.files if k.startswith("extra_")}
    return film, extra
