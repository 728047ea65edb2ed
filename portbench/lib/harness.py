"""One run of one cell: find its files by name, build, warm up, measure a
window (or trace one), check the outputs against the reference, and make
the result line.

Files, found by the names in `BENCHMARK.json`:

* `portbench/workloads/<cell>.json`: the cell's config and mix (which must
  be those `BENCHMARK.json` gives it), parameters that override the mix's,
  and the limit of every number its check compares;
* `portbench/configs/<config>.json`: the scene XML and `compile_scene`'s
  arguments;
* `portbench/traffic/<mix>.json`: the entry it drives and its
  parameters;
* `portbench/entries/<entry>.py`: the entry, the code that drives the
  program through the cell's traffic, reports its end-to-end values and
  checks its outputs (`lib/traffic.py`);
* `portbench/metrics/<metric>.py`: one per-layer metric: `LAYER`, `UNIT`,
  `SOURCE`, `MOVES` and `read(obs)`, which returns the value or None
  where the traced run holds nothing to read.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import resource
import sys
import time

import numpy as np

from portbench.lib import profile, scenario, traffic

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PB)
BANNED = ("jax", "jaxlib", "flax", "cpu_ray_tracer_tpu")
TRI_BYTES = 36  # three float32 vertices
RAY_BYTES = 24 + 16  # origin and direction read, t, u, v and a triangle id written
NOT_FINITE = 1e308  # the value a check reports for a gap that is NaN or infinite


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(os.path.join(REPO, "BENCHMARK.json"))


def metric_module(name: str):
    path = os.path.join(PB, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    params: dict
    limits: dict
    end_to_end: list
    per_layer: list


def parked_cells(bench: dict | None = None) -> list:
    """The cells whose files `workloads/` holds and `BENCHMARK.json` leaves
    out: kept ready, with their limits, while the program fails them
    (PERF.md's open questions)."""
    bench = benchmark() if bench is None else bench
    listed = {w["name"] for w in bench["workloads"]}
    names = [f[:-len(".json")] for f in os.listdir(os.path.join(PB, "workloads"))]
    return sorted(n for n in names if n not in listed)


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell `name` of `BENCHMARK.json` with its files; raises where a
    file is missing or disagrees with `BENCHMARK.json`.  A parked cell
    (`parked_cells`) loads on one chip with the end-to-end metrics that
    name no cells, so that `calibrate.py` and the tests still drive it."""
    bench = benchmark() if bench is None else bench
    cell = None
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        if name not in parked_cells(bench):
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        cell = _json(os.path.join(PB, "workloads", f"{name}.json"))
        entry = dict(name=name, config=cell["config"], traffic=cell["traffic"], chips=1)
    cell = cell or _json(os.path.join(PB, "workloads", f"{name}.json"))
    for key in ("config", "traffic"):
        if cell[key] != entry[key]:
            raise ValueError(f"{name}: {key} {cell[key]!r} in its file, {entry[key]!r} in "
                             "BENCHMARK.json")
    config = _json(os.path.join(PB, "configs", f"{entry['config']}.json"))
    mix = _json(os.path.join(PB, "traffic", f"{entry['traffic']}.json"))
    traffic.entry_module(mix["entry"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moves)]
    return Cell(name, entry["chips"], config, mix, {**mix["params"], **cell.get("params", {})},
                cell["limits"], e2e, per_layer)


def process_seconds() -> float:
    """Seconds since this process started (the kernel's start time of the
    process, in clock ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


class Run:
    """What a traffic loop sees: the scene, the seed's generators, the size,
    the device and the parameters."""

    def __init__(self, cell: Cell, seed: int, device, scene):
        self.cell, self.params, self.device, self.scene = cell, cell.params, device, scene
        self.width, self.height = cell.params["width"], cell.params["height"]
        self.inputs, self.draws = scenario.streams(seed)


def compile_config(config: dict, device):
    from cpu_ray_tracer_tpu_torch.scene.build import compile_scene

    return compile_scene(os.path.join(REPO, config["scene"]), device=device, **config["compile"])


@dataclasses.dataclass
class Observation:
    """What the per-layer readers read in a traced run."""

    trace: profile.Trace
    iterations: int  # in the traced window
    rays: int  # path segments (or Whitted rays) traced in the window
    levels: int  # depths (or Whitted levels) traced in the window, summed over its iterations
    triangles: int
    build_s: float
    syncs_per_iteration: float
    times_ms: np.ndarray  # each traced iteration's host time, the first from the window's start


def _timed(cell: Cell, loop, seconds: float, device, setup_s: float, split: dict):
    """The closed loop for `seconds` (each iteration's end and rays, from
    the window's start): the cell's end-to-end metrics, as the entry works
    them out, and the iterations attempted; the window's own figures go
    to `split`."""
    traffic.sync(device)
    before = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    records = []
    while not records or records[-1][0] - t0 < seconds:
        records += loop.unit()
    after = resource.getrusage(resource.RUSAGE_SELF)
    ends = np.array([r[0] for r in records]) - t0
    window = ends[-1]
    times = np.diff(ends, prepend=0.0) * 1e3
    sec = ends.astype(int)
    split["window"] = dict(
        seconds=window, ms_median=float(np.median(times)), ms_mean=float(times.mean()),
        ms_p05=float(np.percentile(times, 5)), ms_max=float(times.max()),
        # the iterations' mean ms in each second of the window, for drift
        ms_by_second=[round(float(times[sec == i].mean()), 2) for i in np.unique(sec)],
        **{k: getattr(after, f"ru_{k}") - getattr(before, f"ru_{k}")
           for k in ("utime", "stime", "minflt", "nvcsw", "nivcsw")})
    values = dict(loop.values(times, sum(r[1] for r in records), window), setup_s=setup_s)
    missing = [m["name"] for m in cell.end_to_end if m["name"] not in values]
    if missing:
        raise KeyError(f"{cell.name}: the entry {cell.mix['entry']!r} reports no {missing}")
    return {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
            for m in cell.end_to_end}, len(records)


def _traced(cell: Cell, loop, device, info, build_s: float):
    """`trace_units` units under the profiler and one more counted as it
    dispatches: the per-layer metrics, the device's busy and window
    seconds, the breakdown and the iterations attempted."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile as torch_profile

    # the CPU has no device timeline to read: there the window runs unprofiled
    cuda = device.type == "cuda"
    prof = torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if cuda \
        else contextlib.nullcontext()
    with prof:
        traffic.sync(device)
        t0 = time.perf_counter()
        records = []
        for _ in range(cell.params["trace_units"]):
            records += loop.unit()
        window = time.perf_counter() - t0
    tr = profile.read(prof, window) if cuda else profile.Trace(window, {}, [])
    counts, counted = profile.count_ops(loop.unit)
    ends = np.array([r[0] for r in records]) - t0
    obs = Observation(tr, len(records), loop.traced_rays(records), sum(r[2] for r in records),
                      info.triangle_count, build_s, counts["syncs"] / len(counted),
                      np.diff(ends, prepend=0.0) * 1e3)
    metrics = {}
    for m in cell.per_layer:
        value = metric_module(m["name"]).read(obs)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    return (metrics, dict(busy_s=tr.busy_s, window_s=tr.window_s),
            dict(device_ops=tr.top_ops(), idle_gaps=tr.idle_gaps), len(records) + len(counted))


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
            started: float | None = None) -> tuple[dict, dict]:
    """One run of `cell` on `device` (module docstring): the result line's
    object, and set-up's split (seconds of the interpreter's start, the
    device's start, the build, the warm-up, the window's figures and the
    reference).  `started`: the host clock (perf_counter) when the process
    started."""
    import torch

    started = time.perf_counter() if started is None else started
    device = torch.device(device)
    cuda = device.type == "cuda"
    split = dict(start_s=time.perf_counter() - started)
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=device)
    split["cuda_s"] = time.perf_counter() - started - split["start_s"]
    t = time.perf_counter()
    scene, info = compile_config(cell.config, device)
    traffic.sync(device)
    build_s = split["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    loop = traffic.entry_module(cell.mix["entry"]).Loop(Run(cell, seed, device, scene))
    del scene
    loop.warm_up()
    traffic.sync(device)
    split["warm_up_s"] = time.perf_counter() - t
    split.update(getattr(loop, "warm_split", {}))
    setup_s = time.perf_counter() - started
    out_device, breakdown = {}, None
    if trace:
        metrics, out_device, breakdown, attempted = _traced(cell, loop, device, info, build_s)
    else:
        metrics, attempted = _timed(cell, loop, seconds, device, setup_s, split)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    answers = loop.answers()
    loop.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = check(loop, answers, device)
    split["reference_s"] = time.perf_counter() - t
    # a number that is not finite (a NaN gap) fails its limit, as any number over it
    checks = {k: dict(value=v if math.isfinite(v) else NOT_FINITE, limit=cell.limits[k])
              for k, v in numbers.items()}
    result = dict(correct=all(c["value"] <= c["limit"] for c in checks.values()),
                  attempted=attempted, failed=int(answers.get("repeat_mismatches", 0)),
                  metrics=metrics,
                  device=dict(platform="gpu" if cuda else device.type,
                              kind=torch.cuda.get_device_name(device) if cuda else "cpu",
                              count=cell.chips, memory_peak_bytes=peak, **out_device))
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, split


def check(loop, answers: dict, device) -> dict:
    """The check's numbers: `answers` against the reference in float64."""
    import torch

    from portbench.reference.scene import load_scene

    ref = load_scene(os.path.join(REPO, loop.run.cell.config["scene"]), dtype=torch.float64,
                     device=device)
    return loop.check(answers, ref)
