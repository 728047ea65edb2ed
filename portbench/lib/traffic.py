"""What every traffic entry shares, and how the harness finds an entry.

A mix file (`portbench/traffic/<mix>.json`) names its `entry` and gives
its parameters; a cell file (`portbench/workloads/<cell>.json`) may
override them.  An entry is the module `portbench/entries/<entry>.py`,
found by that name (`entry_module`).  It defines `Loop`, a subclass of
`Entry` below that drives the program and checks its outputs, and
`FAULTS` with `plant(fault, patch)`: the faults its check has to catch,
planted in the program (`lib/faults.py`).  Every entry runs a closed
loop: one user, the next iteration starting when the last has ended in
`torch.cuda.synchronize()` (or in a host read that waits for the
device).
"""

from __future__ import annotations

import functools
import importlib.util
import os
import time

import numpy as np

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def entry_module(name: str):
    """The entry `name`: `portbench/entries/<name>.py`, loaded once."""
    path = os.path.join(PB, "entries", f"{name}.py")
    if not os.path.isfile(path):
        raise ValueError(f"no entry {name!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(f"portbench_entry_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def gap(a: float, b: float) -> float:
    """|a - b| over |b|: a reading `a` against the reference's `b`."""
    return abs(a - b) / max(abs(b), 1e-300)


def geometry_gap(pool: np.ndarray, ref) -> float:
    """The largest difference between the program's world-space triangles
    (v0 | e1 | e2 rows of its pool) and the reference's, over the scene's
    extent."""
    r = np.concatenate([t.double().cpu().numpy() for t in (ref.v0, ref.e1, ref.e2)], axis=1)
    return float(np.abs(pool.astype(np.float64) - r).max() / np.abs(r[:, :3]).max())


class StepLog:
    """A logger for the program's loops: each record and the host clock
    when it came, in memory."""

    def __init__(self):
        self.records, self.times = [], []

    def log(self, record: dict):
        self.times.append(time.perf_counter())
        self.records.append(record)


class Entry:
    """One cell's loop over the program.

    `unit()` runs one unit of the traffic (an image, a frame, a step) and
    returns, for each iteration in it, (the host clock at its end, the rays
    it traced, the depths or levels it traced); set-up calls `warm_up()`.
    After the window `answers()` takes what the check reads, `release()`
    drops the program's state, and `check(answers, ref)` gives the check's
    numbers against the reference scene `ref`; `control(ref)` gives the
    answers worked out by the reference `ref` in its own precision."""

    def __init__(self, run):
        self.run, self.params = run, run.params

    def warm_up(self):
        self.unit()

    def values(self, times_ms: np.ndarray, rays: int, window: float) -> dict:
        """The end-to-end values the entry's cells can report, from the
        window's iteration times (ms), the rays they traced and the
        window's length (s); the harness adds `setup_s`."""
        return dict(rays_per_s=rays / window, iter_ms_p95=float(np.percentile(times_ms, 95)))

    def traced_rays(self, records: list) -> int:
        """The rays the iterations of `records` traced."""
        return sum(r[1] for r in records)
