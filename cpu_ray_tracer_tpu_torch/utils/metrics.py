"""Structured per-step metrics, as the JAX package's
`cpu_ray_tracer_tpu/utils/metrics.py`: the reference's console printf and
ImGui panel (frame ms, rays/s, traversal statistics) as records for a
JSONL sink."""

from __future__ import annotations

import json
import os
import time

import torch

from cpu_ray_tracer_tpu_torch.core import device as device_mod
from cpu_ray_tracer_tpu_torch.ops import kernel_lib


class FrameMetrics:
    """EMA-smoothed frame timing like the reference (2. WhittedStyle/
    renderer.cpp:169-171: avg = (1 - a) avg + a ms, a *= 0.5).  On the card
    `start` and `stop` wait for the device, so a frame's time covers its
    kernels and not only their launches."""

    def __init__(self, width: int, height: int, device=device_mod.DEFAULT):
        self.width = width
        self.height = height
        self.device = device_mod.resolve(device)
        self.avg_ms = 10.0
        self.alpha = 1.0
        self._t0 = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self) -> dict:
        self._sync()
        dt_ms = (time.perf_counter() - self._t0) * 1000.0
        self.avg_ms = (1 - self.alpha) * self.avg_ms + self.alpha * dt_ms
        if self.alpha > 0.05:
            self.alpha *= 0.5
        fps = 1000.0 / self.avg_ms
        mrays = (self.width * self.height) / self.avg_ms / 1000.0  # primary only
        return dict(ms=dt_ms, avg_ms=self.avg_ms, fps=fps, primary_mrays_s=mrays)


def traversal_summary(traversed: torch.Tensor, tested: torch.Tensor) -> dict:
    """Total / average / peak traversal steps and triangle tests of a frame
    (2. WhittedStyle/renderer.cpp:148-152, 164-178); averages are over the
    rays that took at least one step, as m_rayHitCount.  Each counter moves
    to the host once."""
    tr = traversed.reshape(-1).cpu().numpy()
    te = tested.reshape(-1).cpu().numpy()
    hits = (tr > 0).sum()
    return dict(
        total_traversal=int(tr.sum()),
        average_traversal=float(tr.sum() / max(hits, 1)),
        peak_traversal=int(tr.max()) if tr.size else 0,
        total_tests=int(te.sum()),
        average_tests=float(te.sum() / max(hits, 1)),
        peak_tests=int(te.max()) if te.size else 0,
    )


class JsonlLogger:
    """One JSON object a line, appended to `path` ("" logs nothing)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a") if path else None

    def log(self, record: dict):
        if self._f:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()

    def close(self):
        if self._f:
            self._f.close()


def runtime_flags(device=device_mod.DEFAULT, info=None) -> dict:
    """What the port runs on `device`, for self-describing records, as the
    JAX package's `runtime_flags` (utils/metrics.py:70-86 there): the
    device's name, the file name of the CUDA kernel library (its name
    hashes the sources under `csrc/` and the flags; None on the CPU, where
    the plain versions run), `native`, whether the C++ scene builder
    (`accel/native.py`) loads, and with the `SceneInfo` of the scene that
    was built, whether its BVHs came from it, and `sbvh`, whether they
    were asked for as SBVHs (False without `info`).  The JAX package reads
    its CRT_* switches from the environment; the port takes them as
    arguments (`compile_scene`)."""
    from cpu_ray_tracer_tpu_torch.accel import native as native_mod

    dev = device_mod.resolve(device)
    cuda = dev.type == "cuda"
    try:
        native_mod.load()
        loads = True
    except RuntimeError:  # g++ failed: no native build can have run
        loads = False
    return dict(
        device=torch.cuda.get_device_name(dev) if cuda else "cpu",
        kernel_library=os.path.basename(kernel_lib.library_path()) if cuda else None,
        native=loads and (info is None or info.builder == "native"),
        sbvh=bool(info is not None and info.sbvh),
    )
