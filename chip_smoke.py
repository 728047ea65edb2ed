#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`cpu_ray_tracer_tpu_torch`) on one NVIDIA
GPU.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from `cpu_ray_tracer_tpu_torch/csrc/`;
3. every kernel against its plain PyTorch version on the card, on the main
   paths' inputs (`bunny_teapot.xml`, 1280x720, the `bench.py` camera):
   closest hit on the primary rays and on the live bounce rays after the
   first hit, in the order the path tracer launches them; the wavefront
   path tracer on the 921,600 primary rays with k = 1 in the camera's lane
   order (`core/camera.lane_order`, as `render_pass` passes it) and on
   65,536 of them with k = 6, and timed at k = 6 on all 921,600 rays in
   pixel order (as `render_pass(wavefront_depths=6)` runs it); the
   Whitted level kernel and the any hit on the
   arguments that a Whitted frame passes them at levels 0 and 1 (recorded
   from a render through each level route: the level kernel's `inside`,
   the host route's shadow query over every ray of a level, masked to the
   diffuse hits), and the any hit also on the closest hit's rays and t0.
   Integers exact, floats within 1e-6 relative; times of both;
4. the path tracer's main path: `compile_scene` -> `render_pass` at
   1280x720, depth 5, for `wavefront_depths` 0, 1 and 6: one warm-up pass
   each, then 16 passes each, the three in turns; ms per pass, rays
   traced, rays/s, the film's energy, kernel launches per pass;
   `rays_traced` identical across the three, the image finite and
   non-zero;
5. the Whitted tracer's main path: `render` at 1280x720, depth 5, through
   both level routes: one warm-up frame each, then 8 frames each in
   turns; ms per frame,
   `dropped` 0, the image finite and non-zero, the two routes' images
   within the parity tolerance except pixels that are fp-borderline on
   either route (`render/borderline.py`); each pixel beyond tolerance is
   printed with both routes' values and probe readings;
6. 64x40 renders on the card (kernels) against the CPU (plain versions):
   the path tracer at `wavefront_depths` 0 and 1 (`rays_traced` exact) and
   Whitted, images within the parity tolerance except fp-borderline pixels.

The accelerator interchange, on the same scene and camera:

3b. the link walk (closest and any hit) on the `grid` and `kdtree` cell
    forests and the wide walk on the `wide=True` BVH, each against its
    plain version on the card: closest and any hit on the primary rays and
    on the live bounce rays after the first hit (the wide walk also on the
    primary rays in the camera's lane order, its `perm`), and the any hit
    on the arguments of a Whitted host-route frame at levels 0 and 1
    (recorded; level 0 in the lane order), which stand in the kernels
    line; integers exact (steps and tests included), floats within 1e-6
    relative; steps and tests per ray; times of both;
4b. the path tracer at 1280x720, depth 5, for `grid`, `kdtree` and
    `wide=True` at `wavefront_depths=0` and for `wide="bounce"` at its
    default, beside the binary BVH at `wavefront_depths=0` as the
    reference: one warm-up pass each, then 8 passes each in turns; ms per
    pass, rays/s, energy and launches per pass; `rays_traced` within 1e-4
    relative of the reference's, energy within 1e-3;
5b. Whitted's host route for `grid`, `kdtree` and `wide=True`, in turns
    with the binary BVH's host route as the reference, 4 frames each after
    a warm-up frame: `dropped` 0, each image within the parity tolerance of
    the reference's except pixels fp-borderline on either;
6b. 64x40 card against CPU for the four configurations: path tracer
    (`rays_traced` exact) and Whitted, at their defaults.

Scenes past the walk records' old limits (`scene/synthetic.py`):

3c. a BVH of 140 levels (the link walk for the host queries and the link
    branch of the wavefront and Whitted kernels), one of 100 levels (the
    stack walk with more than 64 entries), a leaf of 600 triangles (a
    hand-built BVH, the grid and the KD tree) and 70 cube instances whose
    object ids pass the meta word (the slot table), and the two BVHs, the
    big leaf's BVH and the cubes collapsed into 8-wide nodes (the wide
    walk): every kernel each scene's renders launch against its plain
    version on the 921,600 rays of the default camera (closest and any
    hit, the wide walk also in the lane order; the wavefront kernel at
    k = 2 and the Whitted level in the lane order where the scene takes
    them), then a 64x40 path-tracer pass and Whitted frame on the card
    against the CPU, which must launch those kernels.

The TPU probes, on their own inputs (`cpu_ray_tracer_tpu_torch/benchmarks/`):

7. the leaf-test probe: K6 (Moller-Trumbore per thread, division-free from
   a packed normal) on its 64 tiles of 4096 rays and K7 (the same tests as
   a 3xTF32 tensor-core product) for m = 8, 32, 64, 128 on every ray of
   the 64 tiles, each within 1e-5 relative of its plain version but for
   rays the float64 evaluation explains (`leaf_tolerance.disagreements`;
   their count is printed, an unexplained ray fails); times of both and,
   beside K7, of `torch.matmul` on the same product in float32 (product
   only); K6's SASS instructions a test on its loop's hot path and the
   issue floor they set (`cuobjdump`, the card's SMs and maximum SM
   clock); the SASS of every `mxu_leaf_kernel<m>` holds `HGMMA` (K7 runs
   on `wgmma`); then one drive of `mxu_probe.main`;
8. the node-step probe: K8 for all ten variants on the 921,600 camera rays
   of `bunny_teapot`'s TLAS tables and on as many NaN-case rays
   (`sync_probe.nan_rays`: origins on slab planes, a zero direction
   component, some boxes flattened), equal to its plain version on both;
   times; SASS instructions a ray-step and the issue floor; the SASS of
   each variant holds its block-wide reductions and, but for A, the
   NaN-propagating min / max of its slab test (`FMNMX.NAN`); then one drive
   of `sync_probe.main` over all ten variants.

Gradients (`diff/`), on the main scene and camera:

9. value + grad steps over every key of `diff/grad.PARAM_KEYS` of the L2
   loss against a target rendered at the same `spp_index` from perturbed
   parameters (albedo x0.8, light colour x0.9): (a) the differentiable
   path tracer (`render_pass(differentiable=True)`, the host bounce at
   every depth) at 1280x720, depth 5, nearest taps: a warm-up step, then 8
   timed; ms per step, forward-equivalent rays/s (the forward's
   `rays_traced` over the step's time, as `bench_fwdbwd.py` counts them),
   `torch.cuda.max_memory_allocated` above what earlier phases hold,
   launches per step (each step a
   drive: K1 closest hit once per host depth, no other walk); every
   gradient finite, albedo, light colour and a vertex key non-zero, the
   texels' exactly zero (the nearest tap reads the packed atlas); (b) the
   same on the scene compiled with `bilinear=True`, whose texel gradient is
   non-zero; (c) Whitted (`render(differentiable=True)`, the host level),
   4 timed steps, K1 closest and any hit once per level; (d) 64x40, depth
   2: the gradients of the path tracer (fixed `spp_index`) and of Whitted
   on the card against the CPU's from one scene, over the pixels whose
   images agree (the others must be fp-borderline), within atol 2e-4
   max|g|, rtol 1e-3 (`GRAD_ATOL`); (e) 5 steps of `diff/optimize.make_train_step` at
   1280x720 on the bilinear scene from perturbed albedo, light colour and
   texels, at the target's `spp_index` (common random numbers): the loss
   after the last step below the first step's.

Each drive of a main path (one pass or one frame, a gradient or train
step, or one probe run) sets every kernel's launch count to 0 just before
it and reads the counts just after; every kernel of the path must have
launched.
The line before the last is `{"kernels": [...]}`: per kernel its
launches on the main paths over this run, its launches per pass and per
frame on the default routes (`main_launches`: the path tracer at its
default `wavefront_depths`, Whitted through its level kernel), its
launches per value + grad step (`grad_launches`: the path tracer of 9a,
Whitted of 9c), the PR
that redesigned it (`redesigned`), its time and its plain version's on
the main path's inputs (phase 3), and its bound: the larger of the bytes it
must move (its ray inputs, the scene tables of its work and its outputs,
each once) over 3.35 TB/s and the float32 operations of its walk on these
inputs (31 per slab test and 58 per Moller-Trumbore test of
`csrc/ptraverse.cuh`, times the steps and tests the rays took, from the
kernel's own counters) over 67 TFLOP/s (NVIDIA H100 SXM, at 700 W).  The
scene tables counted are the ones that define the work, whatever layout a
kernel reads: `nodes`, `links`, `tris` and `shade` (or the wide nodes),
never the walk records built from them (`node_records`, `link_records`,
`tris4`: padded and, for the links, one copy per octant), so that the
yardstick does not move with the layout.  For the
probes, 58 operations per K6 test (the probe's arithmetic, whatever form
the kernel computes the test in), K8's slab tests (32 with the count's
add), and for K7 the larger of its three TF32 passes over 495 TFLOP/s and
its 19 epilogue operations per test over 67 TFLOP/s (the tensor cores and
the float32 units are separate pipes, which different warps keep busy at
the same time).  No single PyTorch call computes a BVH walk, a leaf
probe or a walk probe: `library_ms` is null.  The last line is `{"ok":
true, "device": {...}}`.
"""

import copy
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
XML = os.path.join(REPO, "assets", "scenes", "bunny_teapot.xml")
CAMERA = dict(pos=(0.0, 0.3, -1.2), target=(0.0, -0.1, 2.5))  # bench.py
WIDTH, HEIGHT, DEPTH, PASSES, FRAMES = 1280, 720, 5, 16, 8
# phase 9: value + grad steps of the path tracer (each mode) and of Whitted,
# train steps; the pass salt of the gradient drives and their targets; the
# card-against-CPU gradients' depth and tolerance (atol relative to max|g|)
GRAD_STEPS, WHITTED_GRAD_STEPS, TRAIN_STEPS, GRAD_SPP = 8, 4, 5, 1
# (the atol covers rounding residue on both devices: the diffuse weight's
# cosine, analytically constant in the normal, and sky texels whose
# bilinear weight is near 0; at 1e-5 v0 fails by 2.8e-5 on an H100 80GB HBM3)
GRAD_SMALL_DEPTH, GRAD_ATOL, GRAD_RTOL = 2, 2e-4, 1e-3
WAVEFRONT_DEPTHS = (0, 1, 6)
KERNEL_REPEATS = 20
PKG = "cpu_ray_tracer_tpu_torch"
# the accelerator interchange: compile_scene arguments, the walk's kernels
ACCELS = {"grid": dict(accel="grid"), "kdtree": dict(accel="kdtree"), "wide": dict(wide=True)}
ACCEL_PASSES, ACCEL_FRAMES = 8, 4
# the bound (NVIDIA H100 SXM data sheet): device memory rate, float32 rate
# outside the tensor cores; float32 operations per test, read off
# csrc/ptraverse.cuh: a slab test is 12 subtract/multiply, 10 min/max, 3
# compares and 6 NaN tests; a Moller-Trumbore test 58 (cross products,
# dots, one division, the acceptance compares)
BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
SLAB_OPS, MT_OPS = 31, 58
# K7: dense TF32 on the tensor cores (a multiply-add counts 2); float32
# operations per leaf test of its epilogue (csrc/leaf_probe.cu: the
# reciprocal and its guard, three products, the accept chain, the
# candidate and its min)
TF32_OPS_PER_S, MXU_EPILOGUE_OPS = 495e12, 19
# K8: slab tests per ray of each variant (256 steps, E and F test 8 nodes)
SYNC_SLABS = dict(A=0, B=256, C=256, D=256, E1=2048, E2=2048, E8=2048, F0=2048, F1=2048,
                  F2=2048)
# K8: the block-wide reductions each variant must keep in its SASS
# (sync_probe_kernel<V>): __syncthreads_or is BAR.RED, a warp sum REDUX
SYNC_SASS = dict(C={"BAR.RED": 1}, D={"REDUX": 1}, E1={"REDUX": 1}, E2={"REDUX": 2},
                 E8={"BAR.RED": 8}, F0={"BAR.RED": 8}, F1={"BAR.RED": 8}, F2={"BAR.RED": 8})
# the probe kernels' shapes (csrc/leaf_probe.cu, csrc/sync_probe.cu), for
# the issue floors: K6 runs 2 rays a thread in blocks of 256 and tests 2
# triangles a round of its loop; K8 runs a tile in one block of 1,024
# threads of 4 rays
VPU_RAYS_PER_BLOCK, VPU_TESTS_PER_LOOP = 512, 4
SYNC_THREADS, SYNC_RAYS_PER_THREAD = 1024, 4


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, repeats: int) -> float:
    """Mean ms of `fn()` over `repeats` runs after one warm-up run."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def nbytes(*xs) -> int:
    import torch

    return sum(x.numel() * x.element_size() for x in xs if isinstance(x, torch.Tensor))


def roofline(moved: int, t_ops: float) -> dict:
    """The bound of a call that moves `moved` bytes and computes for
    `t_ops` ms at the card's peak rates."""
    t_bytes = 1e3 * moved / BYTES_PER_S
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=moved)


def profiled_ms(fn, kernel: str, repeats: int = 10) -> float:
    """Mean device ms per call of the kernels named `kernel` that `fn()`
    launches (`torch.profiler`): the kernel alone, without the host time
    of the wrapper around it, which a short kernel does not cover."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages() if kernel in e.key)
    return us / 1e3 / repeats


def timed_once(fn):
    """(fn's result, ms of that one call on the card)."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(inputs: list, tables: list, got, counters: dict, slabs: int, n: int) -> dict:
    """The least time the card could take for a walk kernel's call: bytes
    (inputs, tables, outputs, each once) over the memory rate against the
    walk's float32 operations (`slabs` slab tests per step, one
    Moller-Trumbore test per triangle test, three reciprocals per ray)
    over the float32 rate."""
    outs = list(got.values()) if isinstance(got, dict) else [got]
    ops = (slabs * SLAB_OPS * int(counters["traversed"].sum())
           + MT_OPS * int(counters["tested"].sum()) + 3 * n)
    return dict(roofline(nbytes(*inputs, *tables, *outs), 1e3 * ops / F32_OPS_PER_S), ops=ops)


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return 1e6 * float(out.stdout.strip().splitlines()[0])


def sass_of(path: str) -> str:
    """The SASS of the library at `path` (`cuobjdump -sass`)."""
    from torch.utils.cpp_extension import CUDA_HOME

    return subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", path],
                          capture_output=True, text=True, check=True, timeout=300).stdout


def sass_functions(sass: str, kernel: str) -> dict:
    """Per instantiation of the templated `kernel` (its template arguments
    as they are mangled, `ILi128EE` -> "128"; "" for a plain function):
    its SASS lines."""
    import re

    funcs, key = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            key = None
            if kernel in name:
                found = re.search(kernel + r"I((?:Li\d+E)+)E", name)
                key = ",".join(re.findall(r"Li(\d+)E", found.group(1))) if found else ""
                funcs[key] = []
        elif key is not None:
            funcs[key].append(line)
    return funcs


def sass_counts(sass: str, kernel: str, ops) -> dict:
    """Per instantiation of `kernel` (`sass_functions`): counts of the SASS
    instructions `ops`."""
    return {key: {op: n for op in ops if (n := sum(op in line for line in lines))}
            for key, lines in sass_functions(sass, kernel).items()}


def loop_instructions(sass: str, kernel: str) -> dict:
    """Per instantiation of `kernel` (`sass_functions`): the SASS
    instructions of its main loop (the one the last backward branch
    closes: the probes' loops over triangles and steps come last) on the
    hot path, that is without NOPs and without the largest region a
    predicated forward branch inside the loop skips (the rare accept of K6,
    the leaf loop of F1 and F2)."""
    import re

    out = {}
    for key, lines in sass_functions(sass, kernel).items():
        code = [(int(m.group(1), 16), m.group(2).strip()) for line in lines
                if (m := re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line))]
        at = {addr: i for i, (addr, _) in enumerate(code)}
        branches = [(i, int(m.group(1), 16)) for i, (_, text) in enumerate(code)
                    if (m := re.search(r"\bBRA\s+(?:!?U?P\w+,\s*)?0x([0-9a-f]+)", text))]
        start, end = [(at[t], i) for i, t in branches if t < code[i][0] and t in at][-1]
        skips = [range(i + 1, at[t]) for i, t in branches
                 if start <= i < end and code[i][0] < t <= code[end][0] and t in at
                 and code[i][1].startswith("@")]
        cold = max(skips, key=len, default=range(0))
        out[key] = sum(1 for i in range(start, end + 1)
                       if i not in cold and not code[i][1].startswith("NOP"))
    return out


def issue_floor_ms(lane_instructions: float, blocks: int, sms: int, clock_hz: float) -> float:
    """The least time the card could issue a call whose `blocks` equal
    blocks each take `lane_instructions` (per-thread instructions summed
    over the block's threads): the busiest SM's blocks over its 4
    schedulers x 32 lanes an instruction each per clock."""
    return 1e3 * -(-blocks // sms) * lane_instructions / (4 * 32 * clock_hz)


def compare(name: str, label: str, kernel, plain, n: int, work=None) -> dict:
    """`kernel()` against `plain()` on the card: every integer and bool
    output exact, every float within 1e-6 relative; both timed.  `work(got)`
    gives the call's bound (`bound`)."""
    import torch

    got = kernel()
    want, plain_ms = timed_once(plain)  # once: the plain version repeats the kernel's arithmetic
    if not isinstance(got, dict):
        got, want = {"out": got}, {"out": want}
    max_err, bitwise = 0.0, 0
    for key in sorted(want):
        g, w = got[key], want[key]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name} {label}: {key} is {g.dtype}{tuple(g.shape)}, "
                                 f"plain {w.dtype}{tuple(w.shape)}")
        if g.is_floating_point():
            diff = (g - w).abs()
            bitwise += int((g.view(torch.int32) != w.view(torch.int32)).sum())
            beyond = int((diff > 1e-6 * w.abs()).sum())
            if beyond:
                raise AssertionError(
                    f"{name} {label}: {key} beyond 1e-6 relative on {beyond} values, "
                    f"max {float(diff.max())}")
            max_err = max(max_err, float(diff.max()) if diff.numel() else 0.0)
        else:
            bad = int((g != w).sum())
            if bad:
                raise AssertionError(f"{name} {label}: {key} differs on {bad} of {g.numel()}")
    ms = time_cuda(kernel, KERNEL_REPEATS)
    b = work(got["out"] if set(got) == {"out"} else got) if work else {}
    extra = (f", bound {b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bytes']} bytes, "
             f"{b['ops']} float32 ops), share {b['bound_ms'] / ms:.4f}") if b else ""
    print(f"{name} {label}: {n} rays, integers exact, bitwise float mismatches {bitwise}, "
          f"max abs err {max_err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.1f} ms{extra}")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, got=got, **b)


class Recorder:
    """Calls `fn` and keeps the arguments of each call.  `launches` is
    `fn`'s own count: a wrapper that counts through its module's name for
    itself counts on while it is replaced by a recorder."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self.fn(*args, **kwargs)

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, n: int):
        self.fn.launches = n


def recorded(module, name: str, fn) -> list:
    """Run `fn()` with `module.<name>` replaced by a `Recorder`; returns the
    arguments of each call, one (args, kwargs) per call in order."""
    orig = getattr(module, name)
    rec = Recorder(orig)
    setattr(module, name, rec)
    try:
        fn()
    finally:
        setattr(module, name, orig)
    return rec.calls


def counted(kernels: dict, fn):
    """Run `fn()` with every kernel's launch count set to 0 just before;
    returns (fn's result, the counts just after)."""
    for k in kernels.values():
        k.launches = 0
    out = fn()
    return out, {name: k.launches for name, k in kernels.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU fallback here", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from cpu_ray_tracer_tpu_torch.benchmarks import leaf_tolerance, mxu_probe
    from cpu_ray_tracer_tpu_torch.benchmarks import sync_probe as sync_bench
    from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
    from cpu_ray_tracer_tpu_torch.diff import grad as grad_mod
    from cpu_ray_tracer_tpu_torch.diff.optimize import make_train_step
    from cpu_ray_tracer_tpu_torch.ops import (
        closest_hit as stack_walk, intersect, kernel_lib, leaf_probe, link_walk, sync_probe,
        wavefront_pt, whitted_wf, wide_bvh,
    )
    from cpu_ray_tracer_tpu_torch.ops.closest_hit import (
        closest_hit, closest_hit_plain, occluded, occluded_plain,
    )
    from cpu_ray_tracer_tpu_torch.render import borderline, pathtracer, whitted
    from cpu_ray_tracer_tpu_torch.scene import query, synthetic
    from cpu_ray_tracer_tpu_torch.scene.build import compile_scene

    kernels = dict(closest_hit=closest_hit, occluded=occluded,
                   wavefront_pt=wavefront_pt.trace, whitted_wf=whitted_wf.trace_level0,
                   closest_hit_links=link_walk.closest_hit_links,
                   occluded_links=link_walk.occluded_links,
                   closest_hit_wide=wide_bvh.closest_hit_wide, occluded_wide=wide_bvh.occluded_wide)
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card_line = card()
    print(card_line)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}")

    # --- 2. build ----------------------------------------------------------
    k = kernel_lib.load()
    print(f"kernel library built in {k.build_seconds:.1f} s: {os.path.relpath(k.path, REPO)}")
    for line in k.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  nvcc: {line.strip()}")

    # --- 3. each kernel against its plain version, main-path inputs --------
    start = time.perf_counter()
    cpu_scene, info = compile_scene(XML, device="cpu")
    print(f"scene: {info}, compiled in {time.perf_counter() - start:.2f} s")
    scene = copy.deepcopy(cpu_scene).to(dev)
    camera = cam_mod.make_camera(WIDTH, HEIGHT, **CAMERA)
    o, d, seeds = pathtracer.camera_rays(camera, 1, dev)
    t0, _ = intersect.primitive_hits(scene, o, d)
    n = o.shape[0]
    everyone = torch.ones(n, dtype=torch.bool, device=dev)
    res = {}

    def keep(key, r):
        """The first result of a kernel stands in the kernels line; later
        ones add their error."""
        if key in res:
            res[key]["max_abs_err"] = max(res[key]["max_abs_err"], r["max_abs_err"])
        else:
            res[key] = r

    def work_of(args, names, slabs, any_walk=None):
        """work(got) of a walk kernel's call with positional `args` (scene
        first): its tensors in, the scene tables `names`, its outputs; the
        steps and tests from its own counters, or for an any-hit kernel
        from its plain walk's (`any_walk`)."""
        sc = args[0]

        def work(got):
            counters = got if any_walk is None else any_walk(*args[:5], any_hit=True)
            return bound(list(args[1:]), [getattr(sc, nm) for nm in names], got, counters,
                         slabs, args[1].shape[0])
        return work

    def bounce_rays(sc):
        """The live rays after the first hit, in the order the path tracer
        launches them, with their t0 and mask."""
        state = pathtracer.bounce_step(sc, pathtracer.initial_state(o, d, seeds), 0, DEPTH)
        live = torch.nonzero(state["alive"]).squeeze(1)
        live = live[pathtracer.locus_order(state["d"][live], state["locus"][live])]
        bo, bd = state["o"][live].contiguous(), state["d"][live].contiguous()
        bt0, _ = intersect.primitive_hits(sc, bo, bd)
        return sc, bo, bd, bt0, torch.ones(bo.shape[0], dtype=torch.bool, device=dev)

    # the bound's tables: those that define the work, not the walk records
    # the kernels read (module docstring)
    stack_tables = ("nodes", "tris", "shade")
    args = (scene, o, d, t0, everyone)
    keep("closest_hit", compare("closest_hit", "primary", lambda: closest_hit(*args),
                                lambda: closest_hit_plain(*args), n,
                                work_of(args, stack_tables, 2)))
    bargs = bounce_rays(scene)
    keep("closest_hit", compare("closest_hit", "bounce", lambda: closest_hit(*bargs),
                                lambda: closest_hit_plain(*bargs), bargs[1].shape[0],
                                work_of(bargs, stack_tables, 2)))
    # the fused kernels take a frame's camera rays in the camera's lane
    # order, as render_pass and whitted.render pass it
    lanes = cam_mod.lane_order(camera, dev)
    wf_args = (scene, o, d, seeds)
    keep("wavefront_pt", compare(
        "wavefront_pt", "k=1 primary, lane order",
        lambda: wavefront_pt.trace(*wf_args, 1, DEPTH, perm=lanes),
        lambda: wavefront_pt.trace_plain(*wf_args, 1, DEPTH), n,
        work_of(wf_args, (*stack_tables, "kernel_params"), 2)))
    m = 65536  # every 14th primary ray: the whole frame, not its top rows of sky
    so6, sd6, ss6 = (x[::14][:m].contiguous() for x in (o, d, seeds))
    wf6 = compare(
        "wavefront_pt", "k=6 primary[::14][:65536]",
        lambda: wavefront_pt.trace(scene, so6, sd6, ss6, 6, DEPTH),
        lambda: wavefront_pt.trace_plain(scene, so6, sd6, ss6, 6, DEPTH), m)
    print(f"  k=6 live counts {wf6['got']['live_counts'].tolist()}")
    # k = 6 on all 921,600 rays in pixel order, as
    # render_pass(wavefront_depths=6) runs it: timed, with its bound from
    # its own counters and the plain version's time taken on the 65,536
    # rays above
    got6 = wavefront_pt.trace(*wf_args, 6, DEPTH)
    ms6 = time_cuda(lambda: wavefront_pt.trace(*wf_args, 6, DEPTH), KERNEL_REPEATS)
    b6 = work_of(wf_args, (*stack_tables, "kernel_params"), 2)(got6)
    print(f"wavefront_pt k=6 all {n} rays: kernel {ms6:.4f} ms, live counts "
          f"{got6['live_counts'].tolist()}, bound {b6['bound_ms']:.4f} ms by "
          f"{b6['bound_by']}, share {b6['bound_ms'] / ms6:.4f} (plain on 65,536 of them: "
          f"{wf6['plain_ms']:.1f} ms)")
    # the Whitted level kernel and the any hit on the arguments the two
    # Whitted routes pass them at levels 0 and 1 (level 1's refracted rays
    # carry `inside`; the host route's shadow query takes every ray of a
    # level with the diffuse hits as its mask)
    wf_calls = recorded(whitted_wf, "trace_level0",
                        lambda: whitted.render(scene, camera, DEPTH, True))
    occ_calls = recorded(query, "occluded", lambda: whitted.render(scene, camera, DEPTH, False))
    for key, kernel, plain, calls, work in (
        ("whitted_wf", whitted_wf.trace_level0, whitted_wf.trace_level0_plain, wf_calls,
         lambda a: work_of(a, (*stack_tables, "kernel_params"), 2)),
        ("occluded", occluded, occluded_plain, occ_calls,
         lambda a: work_of(a, stack_tables[:2], 2, stack_walk._walk_plain)),
    ):
        for level in (0, 1):
            args, kwargs = calls[level]
            r = compare(key, f"Whitted level {level}", lambda f=kernel: f(*args, **kwargs),
                        lambda f=plain: f(*args, **kwargs), args[1].shape[0], work(args))
            if key == "whitted_wf":
                print(f"  inside {int(args[3].sum())}, diffuse surfaces lit "
                      f"{int(r['got']['vis'].sum())}")
            else:
                print(f"  mask {int(args[4].sum())}, occluded {int(r['got']['out'].sum())}")
            keep(key, r)
    # the any hit on the closest hit's rays and t0 as well (after the
    # Whitted inputs, which stand in the kernels line)
    for label, a in (("primary", (scene, o, d, t0, everyone)), ("bounce", bargs)):
        r = compare("occluded", label, lambda a=a: occluded(*a), lambda a=a: occluded_plain(*a),
                    a[1].shape[0], work_of(a, stack_tables[:2], 2, stack_walk._walk_plain))
        print(f"  occluded {int(r['got']['out'].sum())}")
        keep("occluded", r)
    wo, wd = cam_mod.full_frame_rays(camera, device=dev)

    # --- 3b. the link walk and the wide walk, main-path inputs --------------
    cpu_scenes, gpu_scenes = {}, {}
    for acc, kwargs in (*ACCELS.items(), ("bounce", dict(wide="bounce"))):
        start = time.perf_counter()
        cpu_scenes[acc], info_a = compile_scene(XML, device="cpu", **kwargs)
        gpu_scenes[acc] = copy.deepcopy(cpu_scenes[acc]).to(dev)
        print(f"scene {acc}: {info_a}, walk {gpu_scenes[acc].walk}, wide nodes "
              f"{0 if gpu_scenes[acc].wide_nodes is None else gpu_scenes[acc].wide_nodes.shape[0]}"
              f", roots {gpu_scenes[acc].roots}, compiled in {time.perf_counter() - start:.2f} s")
    for acc in ACCELS:
        sc = gpu_scenes[acc]
        if sc.walk == "links":
            mod, suffix, slabs, names = link_walk, "links", 1, ("nodes", "links", "tris", "shade")
        else:
            mod, suffix, slabs, names = wide_bvh, "wide", 8, ("wide_nodes", "wide_roots", "tris",
                                                             "shade")
        kc, ko = f"closest_hit_{suffix}", f"occluded_{suffix}"
        ch, ch_plain = getattr(mod, kc), getattr(mod, f"{kc}_plain")
        oc, oc_plain = getattr(mod, ko), getattr(mod, f"{ko}_plain")
        at0, _ = intersect.primitive_hits(sc, o, d)
        ray_sets = (("primary", (sc, o, d, at0, everyone)), ("bounce", bounce_rays(sc)))
        if sc.walk == "wide":
            # the primary rays in the camera's lane order, as the host
            # routes pass it at depth 0 / level 0 (`perm`)
            ray_sets += (("primary, lane order", (sc, o, d, at0, everyone, lanes)),)
        for label, a in ray_sets:
            r = compare(kc, f"{acc} {label}", lambda a=a: ch(*a), lambda a=a: ch_plain(*a),
                        a[1].shape[0], work_of(a, names, slabs))
            print(f"  mean steps {float(r['got']['traversed'].float().mean()):.3f}, tests "
                  f"{float(r['got']['tested'].float().mean()):.3f}, hits "
                  f"{int((r['got']['slot'] >= 0).sum())}")
            keep(kc, r)
        # the any-hit arguments of a Whitted frame on the host route, the
        # only route these scenes take
        calls = recorded(query, ko, lambda sc=sc: whitted.render(sc, camera, DEPTH))
        for level in (0, 1):
            a = calls[level][0]
            r = compare(ko, f"{acc} Whitted level {level}", lambda a=a: oc(*a),
                        lambda a=a: oc_plain(*a), a[1].shape[0],
                        work_of(a, names[:-1], slabs, mod._walk_plain))
            print(f"  mask {int(a[4].sum())}, occluded {int(r['got']['out'].sum())}")
            keep(ko, r)
        for label, a in ray_sets:  # and on the closest hit's rays and t0
            r = compare(ko, f"{acc} {label}", lambda a=a: oc(*a), lambda a=a: oc_plain(*a),
                        a[1].shape[0], work_of(a, names[:-1], slabs, mod._walk_plain))
            print(f"  occluded {int(r['got']['out'].sum())}")
            keep(ko, r)

    # --- 3c. scenes past the walk records' old limits ----------------------
    # (scene/synthetic.py) a BVH of 140 levels (the link walk, K3/K4's link
    # branch), one of 100 (the stack walk past 64 entries), a leaf of 600
    # triangles (BVH, grid, KD tree) and object ids past the meta word
    limit_dir = os.path.join(REPO, "build", "smoke_scenes")
    os.makedirs(limit_dir, exist_ok=True)
    assets = os.path.join(REPO, "assets")
    base_cpu, _ = compile_scene(os.path.join(assets, "scenes", "cube_scene.xml"), device="cpu")
    big_xml = synthetic.big_leaf_xml(limit_dir, assets)
    limits = {
        "deep 140": synthetic.scene_over(base_cpu, synthetic.caterpillar(140)),
        "deep 100": synthetic.scene_over(base_cpu, synthetic.caterpillar(100)),
        "big leaf bvh": synthetic.scene_over(compile_scene(big_xml, device="cpu")[0],
                                             synthetic.big_leaf_bvh()),
        "big leaf grid": compile_scene(big_xml, device="cpu", accel="grid")[0],
        "big leaf kdtree": compile_scene(big_xml, device="cpu", accel="kdtree")[0],
        "cubes70": compile_scene(synthetic.cubes_xml(limit_dir, assets), device="cpu")[0],
        # the same scenes collapsed into 8-wide nodes: the wide walk past
        # 64 stack entries (24 and 34 node ids), a leaf past the count
        # field (the open leaf form) and the slot table
        "deep 140 wide": synthetic.scene_over(base_cpu, synthetic.caterpillar(140), wide=True),
        "deep 100 wide": synthetic.scene_over(base_cpu, synthetic.caterpillar(100), wide=True),
        "big leaf wide": synthetic.scene_over(compile_scene(big_xml, device="cpu")[0],
                                              synthetic.big_leaf_bvh(), wide=True),
        "cubes70 wide": compile_scene(synthetic.cubes_xml(limit_dir, assets), device="cpu",
                                      wide=True)[0],
    }
    lcam, lsmall = cam_mod.make_camera(WIDTH, HEIGHT), cam_mod.make_camera(64, 40)
    lo, ld, ls = pathtracer.camera_rays(lcam, 1, dev)
    llanes = cam_mod.lane_order(lcam, dev)
    for label, sc_cpu in limits.items():
        sc = copy.deepcopy(sc_cpu).to(dev)
        lt0, _ = intersect.primitive_hits(sc, lo, ld)
        a = (sc, lo, ld, lt0, everyone)
        mod, suffix = dict(links=(link_walk, "_links"), wide=(wide_bvh, "_wide")).get(
            sc.walk, (stack_walk, ""))
        walk_keys = (f"closest_hit{suffix}", f"occluded{suffix}")
        print(f"scene {label}: walk {sc.walk}, stack walk {sc.stack_walk}, fused kernels "
              f"{sc.stack_kernels}, depth {sc.depth}, nodes {sc.nodes.shape[0]}, slots "
              f"{sc.tris.shape[0]}, largest leaf {int(sc.nodes[:, 7].max())}, slot table "
              f"{sc.slot_ids is not None}, wide nodes "
              f"{0 if sc.wide_nodes is None else sc.wide_nodes.shape[0]}, wide stack "
              f"{sc.wide_stack}")
        walk_args = [("primary", a)]
        if sc.walk == "wide":  # and in the camera's lane order, as the host routes pass it
            walk_args.append(("primary, lane order", (*a, llanes)))
        for rays_label, wa in walk_args:
            r = compare(walk_keys[0], f"{label} {rays_label}",
                        lambda wa=wa: getattr(mod, walk_keys[0])(*wa),
                        lambda wa=wa: getattr(mod, f"{walk_keys[0]}_plain")(*wa), n)
            print(f"  mean steps {float(r['got']['traversed'].float().mean()):.3f}, tests "
                  f"{float(r['got']['tested'].float().mean()):.3f}, hits "
                  f"{int((r['got']['slot'] >= 0).sum())}, largest object id "
                  f"{int(r['got']['obj_id'].max())}")
            keep(walk_keys[0], r)
            r = compare(walk_keys[1], f"{label} {rays_label}",
                        lambda wa=wa: getattr(mod, walk_keys[1])(*wa),
                        lambda wa=wa: getattr(mod, f"{walk_keys[1]}_plain")(*wa), n)
            keep(walk_keys[1], r)
        expected_pass, expected_frame = [walk_keys[0]], [walk_keys[0], walk_keys[1]]
        if sc.stack_kernels:
            keep("wavefront_pt", compare(
                "wavefront_pt", f"{label} k=2, lane order",
                lambda sc=sc: wavefront_pt.trace(sc, lo, ld, ls, 2, DEPTH, perm=llanes),
                lambda sc=sc: wavefront_pt.trace_plain(sc, lo, ld, ls, 2, DEPTH), n))
            keep("whitted_wf", compare(
                "whitted_wf", f"{label} level 0, lane order",
                lambda sc=sc: whitted_wf.trace_level0(sc, lo, ld, perm=llanes),
                lambda sc=sc: whitted_wf.trace_level0_plain(sc, lo, ld), n))
            expected_pass, expected_frame = ["wavefront_pt", walk_keys[0]], ["whitted_wf"]
        # 64x40 on the card (kernels) against the CPU (plain versions), at
        # the scene's defaults; each drive must launch the kernels above
        (img_gpu, st_gpu), counts = counted(
            kernels, lambda sc=sc: pathtracer.render_pass(sc, lsmall, 1, DEPTH))
        (w_out, w_counts) = counted(kernels, lambda sc=sc: whitted.render(sc, lsmall, DEPTH))
        for key in expected_pass:
            if counts[key] == 0:
                raise AssertionError(f"{label}: render_pass never launched {key}")
        for key in expected_frame:
            if w_counts[key] == 0:
                raise AssertionError(f"{label}: whitted.render never launched {key}")
        img_cpu, st_cpu = pathtracer.render_pass(sc_cpu, lsmall, 1, DEPTH)
        cmp = borderline.unexplained_pixels(
            lambda oo, dd, ss, sc=sc_cpu: pathtracer.sample_radiance(sc, oo, dd, ss, DEPTH)[0],
            pathtracer.camera_rays(lsmall, 1, "cpu"), img_gpu.cpu(), img_cpu)
        w_cpu = whitted.render(sc_cpu, lsmall, DEPTH)["image"]
        wcmp = borderline.unexplained_pixels(
            lambda oo, dd, _, sc=sc_cpu: whitted.radiance(sc, oo, dd, DEPTH)[0],
            (*cam_mod.full_frame_rays(lsmall, device="cpu"), None), w_out["image"].cpu(), w_cpu)
        print(f"  64x40 cuda vs cpu: render_pass rays_traced {st_gpu['rays_traced']} vs "
              f"{st_cpu['rays_traced']}, pixels beyond tolerance {cmp['bad'].numel()}, not "
              f"fp-borderline {cmp['unexplained'].numel()}, launches "
              f"{ {key: c for key, c in counts.items() if c} }; whitted pixels beyond tolerance "
              f"{wcmp['bad'].numel()}, not fp-borderline {wcmp['unexplained'].numel()}, levels "
              f"{w_out['levels']}, launches { {key: c for key, c in w_counts.items() if c} }")
        if (st_gpu["rays_traced"] != st_cpu["rays_traced"] or cmp["unexplained"].numel()
                or wcmp["unexplained"].numel() or not float(img_cpu.sum()) > 0):
            raise AssertionError(f"{label}: the card's render differs from the CPU's")
        del sc
        torch.cuda.empty_cache()

    # --- 4. the path tracer's main path --------------------------------------
    # The configurations run in turns, pass by pass (0, 1, 6, 6, 1, 0, ...),
    # so that a drift of the host or the card over the call hits them alike.
    launches = {key: 0 for key in kernels}

    def drive(label, fn, expected):
        """One drive of a main path, its kernels' counts from 0; returns
        (fn's result, seconds, counts)."""
        torch.cuda.synchronize()
        start = time.perf_counter()
        (out, counts) = counted(kernels, lambda: (fn(), torch.cuda.synchronize())[0])
        seconds = time.perf_counter() - start
        for key in expected:
            if counts[key] == 0:
                raise AssertionError(f"{label}: {key} was never launched")
        for key in launches:
            launches[key] += counts[key]
        return out, seconds, counts

    def turns(configs, n):
        for i in range(n):
            yield from (configs if i % 2 == 0 else configs[::-1])

    runs = {kd: dict(seconds=[], rays=0, counts={}, film=torch.zeros(
        (HEIGHT, WIDTH, 3), dtype=torch.float32, device=dev)) for kd in WAVEFRONT_DEPTHS}
    for kd in WAVEFRONT_DEPTHS:
        pathtracer.render_pass(scene, camera, 100, DEPTH, kd)  # warm-up
    for i, kd in enumerate(turns(WAVEFRONT_DEPTHS, PASSES)):
        # k > DEPTH runs every depth in the wavefront kernel: no host bounce
        expected = (["wavefront_pt"] if kd else []) + (["closest_hit"] if kd <= DEPTH else [])
        (img, stats), seconds, counts = drive(
            f"wavefront_depths={kd}",
            lambda kd=kd, p=i // len(WAVEFRONT_DEPTHS): pathtracer.render_pass(
                scene, camera, p + 1, DEPTH, kd),
            expected,
        )
        if img.shape != (HEIGHT, WIDTH, 3):
            raise AssertionError(f"render_pass returned shape {tuple(img.shape)}")
        r = runs[kd]
        r["film"] += img
        r["rays"] += stats["rays_traced"]
        r["seconds"].append(seconds)
        r["counts"] = {key: r["counts"].get(key, 0) + c for key, c in counts.items() if c}
    for kd, r in runs.items():
        energy = float(r["film"].sum()) / PASSES
        if not bool(torch.isfinite(r["film"]).all()) or energy <= 0.0:
            raise AssertionError(f"wavefront_depths={kd}: bad film, energy {energy}")
        seconds = sorted(r["seconds"])
        total = sum(seconds)
        print(
            f"render_pass {WIDTH}x{HEIGHT} depth {DEPTH} wavefront_depths={kd}: {PASSES} passes, "
            f"{1e3 * total / PASSES:.2f} ms/pass (median {1e3 * seconds[PASSES // 2]:.2f}), "
            f"rays_traced {r['rays']}, {r['rays'] / total:.4g} rays/s, energy {energy:.6g}, "
            f"launches per pass { {key: c / PASSES for key, c in r['counts'].items()} }"
        )
    if len({r["rays"] for r in runs.values()}) != 1:
        raise AssertionError(
            f"rays_traced differs across wavefront_depths: { {k: r['rays'] for k, r in runs.items()} }")

    # --- 4b. the path tracer over the other accelerators, in turns ---------
    # (scene, wavefront_depths, kernels the pass must launch); the binary
    # BVH at wavefront_depths=0 is the reference
    configs = {
        "bvh k=0": (scene, 0, ["closest_hit"]),
        "grid k=0": (gpu_scenes["grid"], 0, ["closest_hit_links"]),
        "kdtree k=0": (gpu_scenes["kdtree"], 0, ["closest_hit_links"]),
        "wide k=0": (gpu_scenes["wide"], 0, ["closest_hit_wide"]),
        "bounce default": (gpu_scenes["bounce"], None, ["wavefront_pt", "closest_hit_wide"]),
    }
    runs_b = {label: dict(seconds=[], rays=0, counts={}, film=torch.zeros(
        (HEIGHT, WIDTH, 3), dtype=torch.float32, device=dev)) for label in configs}
    for sc, kd, _ in configs.values():
        pathtracer.render_pass(sc, camera, 100, DEPTH, kd)  # warm-up
    for i, label in enumerate(turns(list(configs), ACCEL_PASSES)):
        sc, kd, expected = configs[label]
        (img, stats), seconds, counts = drive(
            label, lambda sc=sc, kd=kd, p=i // len(configs): pathtracer.render_pass(
                sc, camera, p + 1, DEPTH, kd),
            expected,
        )
        r = runs_b[label]
        r["film"] += img
        r["rays"] += stats["rays_traced"]
        r["seconds"].append(seconds)
        r["counts"] = {key: r["counts"].get(key, 0) + c for key, c in counts.items() if c}
    ref = runs_b["bvh k=0"]
    ref_energy = float(ref["film"].sum()) / ACCEL_PASSES
    for label, r in runs_b.items():
        energy = float(r["film"].sum()) / ACCEL_PASSES
        total = sum(r["seconds"])
        print(
            f"render_pass {WIDTH}x{HEIGHT} depth {DEPTH} {label}: {ACCEL_PASSES} passes, "
            f"{1e3 * total / ACCEL_PASSES:.2f} ms/pass (median "
            f"{1e3 * sorted(r['seconds'])[ACCEL_PASSES // 2]:.2f}), rays_traced {r['rays']}, "
            f"{r['rays'] / total:.4g} rays/s, energy {energy:.6g}, launches per pass "
            f"{ {key: c / ACCEL_PASSES for key, c in r['counts'].items()} }"
        )
        if not bool(torch.isfinite(r["film"]).all()) or energy <= 0.0:
            raise AssertionError(f"{label}: bad film, energy {energy}")
        if abs(r["rays"] - ref["rays"]) > 1e-4 * ref["rays"]:
            raise AssertionError(f"{label}: rays_traced {r['rays']}, the binary BVH {ref['rays']}")
        if abs(energy - ref_energy) > 1e-3 * ref_energy:
            raise AssertionError(f"{label}: energy {energy}, the binary BVH {ref_energy}")

    # --- 5. the Whitted tracer's main path, both level routes in turns -------
    frames = {lk: dict(seconds=[], counts={}) for lk in (True, False)}
    images = {}
    for lk in frames:
        whitted.render(scene, camera, DEPTH, lk)  # warm-up: allocator, sizes
    for lk in turns((True, False), FRAMES):
        out, seconds, counts = drive(
            f"whitted level_kernel={lk}", lambda lk=lk: whitted.render(scene, camera, DEPTH, lk),
            ["whitted_wf"] if lk else ["closest_hit", "occluded"],
        )
        img = out["image"]
        if out["dropped"] != 0 or not bool(torch.isfinite(img).all()) or float(img.sum()) <= 0:
            raise AssertionError(f"whitted level_kernel={lk}: bad frame")
        f = frames[lk]
        f["seconds"].append(seconds)
        f["counts"] = {key: f["counts"].get(key, 0) + c for key, c in counts.items() if c}
        images[lk] = img
        f["out"] = out
    for lk, f in frames.items():
        out = f["out"]
        print(
            f"whitted {WIDTH}x{HEIGHT} depth {DEPTH} level_kernel={lk}: {FRAMES} frames, "
            f"{1e3 * sum(f['seconds']) / FRAMES:.2f} ms/frame, rays {out['rays']} in "
            f"{out['levels']} levels, energy {float(images[lk].sum()):.6g}, dropped "
            f"{out['dropped']}, launches per frame "
            f"{ {key: c / FRAMES for key, c in f['counts'].items()} }"
        )
    # the routes differ in float32 operation order (the level kernel follows
    # the TPU kernel's), so a pixel may differ where either route's path is
    # fp-borderline
    routes = [lambda oo, dd, _, lk=lk: whitted.radiance(scene, oo, dd, DEPTH, lk)[0]
              for lk in (True, False)]
    img_k, img_h = images[True].cpu(), images[False].cpu()
    cmp = borderline.unexplained_pixels(routes[0], (wo, wd, None), img_k, img_h)
    bad = cmp["bad"]
    near_k = ~torch.isin(bad, cmp["unexplained"])  # fp-borderline on the kernel route
    near_h = torch.zeros_like(near_k)
    if bad.numel():
        idx = bad.to(dev)
        near_h = borderline.nudge_sensitive(routes[1], wo[idx], wd[idx], None)
    unexplained = bad[~near_k & ~near_h]
    print(f"whitted routes: pixels beyond tolerance {bad.numel()}, fp-borderline on the "
          f"kernel route {int(near_k.sum())}, on the host route {int(near_h.sum())}, on "
          f"neither {unexplained.numel()}")
    for i, (p, nk, nh) in enumerate(zip(bad.tolist(), near_k.tolist(), near_h.tolist())):
        if i == 64:
            break
        print(f"  pixel {p}: kernel route {img_k.reshape(-1, 3)[p].tolist()}, host route "
              f"{img_h.reshape(-1, 3)[p].tolist()}, borderline kernel {nk} host {nh}")
    if unexplained.numel():
        raise AssertionError("the two Whitted level routes disagree")

    # --- 5b. Whitted's host route over the other accelerators --------------
    # in turns with the binary BVH's host route, the reference
    walk_kernels = dict(stack=["closest_hit", "occluded"],
                        links=["closest_hit_links", "occluded_links"],
                        wide=["closest_hit_wide", "occluded_wide"])
    host_scenes = dict(bvh=scene, **{acc: gpu_scenes[acc] for acc in ACCELS})
    frames_b = {acc: dict(seconds=[], counts={}) for acc in host_scenes}
    for sc in host_scenes.values():
        whitted.render(sc, camera, DEPTH, False)  # warm-up
    for acc in turns(list(host_scenes), ACCEL_FRAMES):
        sc = host_scenes[acc]
        out, seconds, counts = drive(
            f"whitted {acc}", lambda sc=sc: whitted.render(sc, camera, DEPTH, False),
            walk_kernels[sc.walk],
        )
        f = frames_b[acc]
        f["seconds"].append(seconds)
        f["counts"] = {key: f["counts"].get(key, 0) + c for key, c in counts.items() if c}
        f["out"] = out
    img_h = frames_b["bvh"]["out"]["image"].cpu()
    for acc, f in frames_b.items():
        out, img = f["out"], f["out"]["image"]
        if out["dropped"] != 0 or not bool(torch.isfinite(img).all()) or float(img.sum()) <= 0:
            raise AssertionError(f"whitted {acc}: bad frame")
        sc = host_scenes[acc]
        cmp = borderline.unexplained_pixels(
            lambda oo, dd, _, sc=sc: whitted.radiance(sc, oo, dd, DEPTH, False)[0],
            (wo, wd, None), img.cpu(), img_h)
        bad = cmp["bad"]
        near_a = ~torch.isin(bad, cmp["unexplained"])
        near_h = torch.zeros_like(near_a)
        if bad.numel():
            idx = bad.to(dev)
            near_h = borderline.nudge_sensitive(routes[1], wo[idx], wd[idx], None)
        unexplained = bad[~near_a & ~near_h]
        print(
            f"whitted {WIDTH}x{HEIGHT} depth {DEPTH} {acc} (host route): {ACCEL_FRAMES} frames, "
            f"{1e3 * sum(f['seconds']) / ACCEL_FRAMES:.2f} ms/frame, rays {out['rays']} in "
            f"{out['levels']} levels, energy {float(img.sum()):.6g}, dropped {out['dropped']}, "
            f"launches per frame { {key: c / ACCEL_FRAMES for key, c in f['counts'].items()} }; "
            f"against the binary host route: pixels beyond tolerance {bad.numel()}, "
            f"fp-borderline on {acc} {int(near_a.sum())}, on the binary BVH {int(near_h.sum())}, "
            f"on neither {unexplained.numel()}"
        )
        if unexplained.numel():
            raise AssertionError(f"whitted {acc} disagrees with the binary BVH at "
                                 f"{unexplained[:16].tolist()}")

    # --- 6. card (kernels) against CPU (plain versions) ----------------------
    small = cam_mod.make_camera(64, 40, **CAMERA)
    for kd in (0, 1):
        img_gpu, st_gpu = pathtracer.render_pass(scene, small, 1, DEPTH, kd)
        img_cpu, st_cpu = pathtracer.render_pass(cpu_scene, small, 1, DEPTH, kd)
        cmp = borderline.unexplained_pixels(
            lambda oo, dd, ss, kd=kd: pathtracer.sample_radiance(cpu_scene, oo, dd, ss, DEPTH, kd)[0],
            pathtracer.camera_rays(small, 1, "cpu"), img_gpu.cpu(), img_cpu)
        print(
            f"render_pass 64x40 wavefront_depths={kd} cuda vs cpu: rays_traced "
            f"{st_gpu['rays_traced']} vs {st_cpu['rays_traced']}, pixels beyond tolerance "
            f"{cmp['bad'].numel()} {cmp['bad'].tolist()}, not fp-borderline {cmp['unexplained'].numel()}"
        )
        if st_gpu["rays_traced"] != st_cpu["rays_traced"] or cmp["unexplained"].numel():
            raise AssertionError("the card's render differs from the CPU's")
    w_gpu = whitted.render(scene, small, DEPTH)["image"].cpu()
    w_cpu = whitted.render(cpu_scene, small, DEPTH)["image"]
    so_, sd_ = cam_mod.full_frame_rays(small, device="cpu")
    cmp = borderline.unexplained_pixels(
        lambda oo, dd, _: whitted.radiance(cpu_scene, oo, dd, DEPTH)[0], (so_, sd_, None),
        w_gpu, w_cpu)
    print(f"whitted 64x40 cuda vs cpu: pixels beyond tolerance {cmp['bad'].numel()}, "
          f"not fp-borderline {cmp['unexplained'].numel()}")
    if cmp["unexplained"].numel():
        raise AssertionError("the card's Whitted render differs from the CPU's")
    # 6b. the four configurations of the interchange, at their defaults
    for acc, sc_gpu in gpu_scenes.items():
        sc_cpu = cpu_scenes[acc]
        img_gpu, st_gpu = pathtracer.render_pass(sc_gpu, small, 1, DEPTH)
        img_cpu, st_cpu = pathtracer.render_pass(sc_cpu, small, 1, DEPTH)
        cmp = borderline.unexplained_pixels(
            lambda oo, dd, ss, sc=sc_cpu: pathtracer.sample_radiance(sc, oo, dd, ss, DEPTH)[0],
            pathtracer.camera_rays(small, 1, "cpu"), img_gpu.cpu(), img_cpu)
        w_gpu = whitted.render(sc_gpu, small, DEPTH)["image"].cpu()
        w_cpu = whitted.render(sc_cpu, small, DEPTH)["image"]
        wcmp = borderline.unexplained_pixels(
            lambda oo, dd, _, sc=sc_cpu: whitted.radiance(sc, oo, dd, DEPTH)[0],
            (so_, sd_, None), w_gpu, w_cpu)
        print(
            f"{acc} 64x40 cuda vs cpu: render_pass rays_traced {st_gpu['rays_traced']} vs "
            f"{st_cpu['rays_traced']}, pixels beyond tolerance {cmp['bad'].numel()}, not "
            f"fp-borderline {cmp['unexplained'].numel()}; whitted pixels beyond tolerance "
            f"{wcmp['bad'].numel()}, not fp-borderline {wcmp['unexplained'].numel()}"
        )
        if (st_gpu["rays_traced"] != st_cpu["rays_traced"] or cmp["unexplained"].numel()
                or wcmp["unexplained"].numel()):
            raise AssertionError(f"{acc}: the card's render differs from the CPU's")

    # --- 7. the leaf-test probe: K6 and K7 --------------------------------
    probes = []  # (name, source, replaces, result) of each probe kernel
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = max_sm_clock_hz()
    sass = sass_of(k.path)
    leaf_in = mxu_probe.inputs(mxu_probe.N_TILES, dev)
    tris, comps = leaf_in["tris"], leaf_in["comps"]
    n_leaf = comps[0].numel()
    got = mxu_probe.vpu(leaf_in)
    want, plain_ms = timed_once(lambda: leaf_probe.vpu_leaf_plain(tris, *comps))
    beyond, bad = leaf_tolerance.disagreements(
        got, want, lambda r: leaf_tolerance.vpu_quantities(tris, comps, r), with_uv=True)
    inside = torch.ones(got.numel(), dtype=torch.bool, device=dev)
    inside[beyond.to(dev)] = False
    err = float((got.reshape(-1) - want.reshape(-1))[inside].abs().max())
    ms = time_cuda(lambda: mxu_probe.vpu(leaf_in), KERNEL_REPEATS)
    tests = n_leaf * tris.shape[0] * 8
    b = roofline(nbytes(tris, *comps, got), 1e3 * MT_OPS * tests / F32_OPS_PER_S)
    per_test = loop_instructions(sass, "vpu_leaf_kernel")[""] / VPU_TESTS_PER_LOOP
    blocks = -(-n_leaf // VPU_RAYS_PER_BLOCK)
    floor = issue_floor_ms(per_test * VPU_RAYS_PER_BLOCK * tris.shape[0] * 8, blocks, sms,
                           clock_hz)
    print(f"vpu_leaf (K6): {n_leaf} rays x {tris.shape[0] * 8} triangles, not bit-equal on "
          f"{int((got != want).sum())}, beyond 1e-5 relative {beyond.numel()} (explained by "
          f"the float64 evaluation: {beyond.numel() - bad.numel()}), max abs err of the rest "
          f"{err:.3g}, hits {int((got < 1e29).sum())}, kernel {ms:.4f} ms, plain "
          f"{plain_ms:.1f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']} ({MT_OPS} "
          f"operations a test), share {b['bound_ms'] / ms:.4f}; SASS "
          f"{per_test:.2f} instructions a test on the loop's hot path, issue floor "
          f"{floor:.4f} ms ({sms} SMs x 4 x 32 lanes at {clock_hz / 1e6:.0f} MHz): the kernel "
          f"issues at {floor / ms:.4f} of that rate")
    if bad.numel():
        raise AssertionError(f"vpu_leaf: {bad.numel()} rays beyond tolerance and not "
                             f"borderline, e.g. {bad[:8].tolist()}")
    probes.append(("vpu_leaf", "leaf_probe.cu", "benchmarks/mxu_probe.py:174",
                   dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b)))
    for m in leaf_probe.WIDTHS:
        c_tab, phi = leaf_in["per_m"][m]
        packed = leaf_in["packed"][m]
        got = leaf_probe.mxu_leaf(c_tab, phi, m, packed)
        want, plain_ms = timed_once(lambda: leaf_probe.mxu_leaf_plain(c_tab, phi, m))
        beyond, bad = leaf_tolerance.disagreements(
            got, want, lambda r: leaf_tolerance.mxu_quantities(c_tab, phi, m, r), with_uv=False)
        inside = torch.ones(got.numel(), dtype=torch.bool, device=dev)
        inside[beyond.to(dev)] = False
        err = float((got.reshape(-1) - want.reshape(-1))[inside].abs().max())
        ms = time_cuda(lambda: leaf_probe.mxu_leaf(c_tab, phi, m, packed), KERNEL_REPEATS)
        flush = leaf_probe.n_flush(m)
        tests = got.numel() * flush * m
        # per test 4 rows of C times 16 features, 2 operations each, 3 passes
        t_mma = 1e3 * 3 * 2 * 4 * 16 * tests / TF32_OPS_PER_S
        t_epilogue = 1e3 * MXU_EPILOGUE_OPS * tests / F32_OPS_PER_S
        b = roofline(nbytes(c_tab, phi, got), max(t_mma, t_epilogue))
        torch.backends.cuda.matmul.allow_tf32 = False  # the library's product in full float32
        flat = phi.permute(1, 0, 2).reshape(16, -1).contiguous()
        cm = c_tab[:4 * m].contiguous()
        mm_ms = time_cuda(lambda: torch.matmul(cm, flat), KERNEL_REPEATS) * flush
        print(f"mxu_leaf (K7) m={m}: {got.numel()} rays x {flush} flushes of {m}, beyond 1e-5 "
              f"relative {beyond.numel()} (explained by the float64 evaluation: "
              f"{beyond.numel() - bad.numel()}), max abs err of the rest {err:.3g}, kernel "
              f"{ms:.4f} ms, plain {plain_ms:.1f} ms, bound {b['bound_ms']:.4f} ms by "
              f"{b['bound_by']} (TF32 passes {t_mma:.4f} ms, epilogue {t_epilogue:.4f} ms), "
              f"share {b['bound_ms'] / ms:.4f}; torch.matmul float32 on the "
              f"same {flush} products [{4 * m}, 16] @ [16, {flat.shape[1]}] (product only) "
              f"{mm_ms:.4f} ms")
        if bad.numel():
            raise AssertionError(f"mxu_leaf m={m}: {bad.numel()} rays beyond tolerance and not "
                                 f"borderline, e.g. {bad[:8].tolist()}")
        probes.append((f"mxu_leaf m={m}", "leaf_probe.cu", "benchmarks/mxu_probe.py:193",
                       dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, product_only_ms=mm_ms, **b)))
    # K7 runs on wgmma: every instance of mxu_leaf_kernel<m> holds HGMMA
    hgmma = sass_counts(sass, "mxu_leaf_kernel", ("HGMMA",))
    print(f"  SASS mxu_leaf_kernel<m>: {hgmma}")
    for m in leaf_probe.WIDTHS:
        if not any(key.split(",")[0] == str(m) for key in hgmma):
            raise AssertionError(f"mxu_leaf m={m}: no mxu_leaf_kernel<{m}> in the library")
    for key, have in hgmma.items():
        if have.get("HGMMA", 0) == 0:
            raise AssertionError(f"mxu_leaf_kernel<{key}>: no HGMMA in its SASS")
    leaf_probe.vpu_leaf.launches = 0
    leaf_probe.mxu_leaf.launches = dict.fromkeys(leaf_probe.WIDTHS, 0)
    mxu_probe.main(dev)
    torch.cuda.synchronize()
    probe_launches = {"vpu_leaf": leaf_probe.vpu_leaf.launches,
                      **{f"mxu_leaf m={m}": c for m, c in leaf_probe.mxu_leaf.launches.items()}}

    # --- 8. the node-step probe: K8, every variant ------------------------
    sync_in = sync_bench.inputs(sync_bench.N_TILES, dev)
    nan_in = sync_bench.nan_rays(sync_in, sync_bench.N_TILES)
    aabb, links, rays = sync_in["aabb"], sync_in["links"], sync_in["comps"]
    n_sync = rays[0].numel()
    steps = loop_instructions(sass, "sync_probe_kernel")
    for i, variant in enumerate(sync_probe.VARIANTS):
        got = sync_bench.run(sync_in, variant)
        want, plain_ms = timed_once(
            lambda v=variant: sync_probe.node_walk_plain(aabb, links, rays, v))
        bad = int((got != want).sum())
        nan_got = sync_bench.run(nan_in, variant)
        nan_bad = int((nan_got != sync_probe.node_walk_plain(
            nan_in["aabb"], nan_in["links"], nan_in["comps"], variant)).sum())
        if bad or nan_bad:
            raise AssertionError(f"node_walk {variant}: {bad} of {n_sync} outputs differ on the "
                                 f"camera rays, {nan_bad} on the NaN-case rays")
        ms = time_cuda(lambda v=variant: sync_bench.run(sync_in, v), KERNEL_REPEATS)
        slabs = SYNC_SLABS[variant]
        b = roofline(nbytes(aabb, links, got, *(rays if slabs else [])),
                     1e3 * (SLAB_OPS + 1) * slabs * n_sync / F32_OPS_PER_S)
        ns_step = 1e6 * ms / (sync_bench.N_TILES * sync_probe.STEPS)
        per_step = steps[str(i)] / (4 if variant == "D" else 1)  # D's loop holds 4 steps
        walkers = 32 if variant == "A" else SYNC_THREADS  # one warp walks A's cursor
        floor = issue_floor_ms(per_step * walkers * sync_probe.STEPS, sync_bench.N_TILES, sms,
                               clock_hz)
        # A's kernel is shorter than its wrapper's host time, which the
        # events then measure: its device time beside them
        device = ""
        if variant == "A":
            a_ms = profiled_ms(lambda: sync_bench.run(sync_in, "A"), "sync_probe_kernel")
            device = f", device {a_ms:.4f} ms"
        print(f"node_walk (K8) {variant}: {n_sync} rays, equal, and equal on as many NaN-case "
              f"rays, output range [{float(got.min()):g}, {float(got.max()):g}], kernel "
              f"{ms:.4f} ms ({ns_step:.3f} ns/step){device}, "
              f"plain {plain_ms:.1f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']}, "
              f"share {b['bound_ms'] / ms:.4f}; SASS {per_step / SYNC_RAYS_PER_THREAD:.2f} "
              f"instructions a ray-step (a thread's step over its {SYNC_RAYS_PER_THREAD} rays: "
              f"{per_step:.0f}), issue floor {floor:.4f} ms (the busiest SM's tiles): the "
              f"kernel issues at {floor / ms:.4f} of that rate")
        probes.append((f"node_walk {variant}", "sync_probe.cu", "benchmarks/sync_probe.py:281",
                       dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, **b)))
    counts = sass_counts(sass, "sync_probe_kernel", ("BAR.RED", "REDUX", "BAR.SYNC", "FMNMX.NAN"))
    for i, variant in enumerate(sync_probe.VARIANTS):
        have = counts.get(str(i), {})
        print(f"  SASS sync_probe_kernel<{variant}>: {have}")
        for op, need in SYNC_SASS.get(variant, {}).items():
            if have.get(op, 0) < need:
                raise AssertionError(f"node_walk {variant}: {have.get(op, 0)} {op} in its SASS, "
                                     f"its block-wide reductions need {need}")
        # the slab test's min / max propagate NaN (PTX min.NaN / max.NaN)
        if variant != "A" and have.get("FMNMX.NAN", 0) < 10:
            raise AssertionError(f"node_walk {variant}: {have.get('FMNMX.NAN', 0)} FMNMX.NAN in "
                                 f"its SASS: the slab test's min / max must propagate NaN")
    sync_probe.node_walk.launches = dict.fromkeys(sync_probe.VARIANTS, 0)
    sync_bench.main(sync_probe.VARIANTS, dev)
    torch.cuda.synchronize()
    probe_launches.update({f"node_walk {v}": c for v, c in sync_probe.node_walk.launches.items()})
    for key, count in probe_launches.items():
        if count == 0:
            raise AssertionError(f"{key} was never launched by its probe")

    # --- 9. gradients: the differentiable path tracer and Whitted ----------
    keys = grad_mod.PARAM_KEYS
    cpu_bil, _ = compile_scene(XML, bilinear=True, device="cpu")
    bil = copy.deepcopy(cpu_bil).to(dev)
    walks = [k for k in kernels if k not in ("wavefront_pt", "whitted_wf")]

    def pt_render(sc, cam=camera, depth=DEPTH):
        img, stats = pathtracer.render_pass(sc, cam, GRAD_SPP, depth, differentiable=True)
        return img, stats["rays_traced"]

    def whitted_render(sc, cam=camera, depth=DEPTH):
        out = whitted.render(sc, cam, depth, differentiable=True)
        return out["image"], out["rays"]

    def perturbed(params):
        return dict(params, albedo=params["albedo"] * 0.8, light_color=params["light_color"] * 0.9)

    def grad_drive(label, sc, render, steps, per_step):
        """One warm-up and `steps` timed value + grad steps of the L2 loss of
        `render(sc)` against a target rendered at the same spp_index from
        perturbed parameters, every key of PARAM_KEYS; each step a drive
        of its own (counts from 0).  `per_step`: the walk kernels' launches
        each step must make (no other walk kernel may launch).  Returns
        the last step's gradients and the launches it counted."""
        params = grad_mod.extract_params(sc, keys)
        with torch.no_grad():
            target = render(grad_mod.apply_params(sc, perturbed(params)))[0]
        rays = []

        def loss_fn(p):
            img, r = render(grad_mod.apply_params(sc, p))
            rays.append(r)
            return grad_mod.l2_image_loss(img, target)

        def step():
            (loss, g), counts = counted(kernels, lambda: grad_mod.value_and_grad(loss_fn, params))
            for key in kernels:
                if counts[key] != per_step.get(key, 0):
                    raise AssertionError(f"{label}: {key} launched {counts[key]} times in a step, "
                                         f"expected {per_step.get(key, 0)}")
                launches[key] += counts[key]
            return loss, g, counts

        step()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # the scenes and tables of earlier phases
        start = time.perf_counter()
        for _ in range(steps):
            loss, g, counts = step()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - start) / steps
        peak = torch.cuda.max_memory_allocated() - held
        for key, v in g.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{label}: {key} gradient not finite")
        for key in ("albedo", "light_color"):
            if float(g[key].abs().sum()) == 0:
                raise AssertionError(f"{label}: {key} gradient is zero")
        print(f"{label} {WIDTH}x{HEIGHT} depth {DEPTH}: {steps} value+grad steps, {ms:.2f} ms/step, "
              f"forward rays {rays[-1]}, {1e3 * rays[-1] / ms:.4g} rays/s (forward-equivalent), "
              f"peak memory allocated by the steps {peak} bytes ({peak / 2**30:.3f} GiB, above "
              f"the {held} held before them), launches per step "
              f"{ {k: c for k, c in counts.items() if c} }, loss {float(loss):.6g}; sum |g| "
              f"{ {k: float(v.abs().sum()) for k, v in g.items()} }; {card_line}")
        return dict(grads=g, counts=counts, ms=ms)

    # (a), (b): the path tracer, nearest (the packed atlas: no texel
    # gradient) and bilinear; K1 closest hit once per host depth
    pt_steps = dict(closest_hit=DEPTH + 1)
    grad_runs = {}
    for label, sc in (("grad path tracer nearest", scene), ("grad path tracer bilinear", bil)):
        r = grad_drive(label, sc, pt_render, GRAD_STEPS, pt_steps)
        g = r["grads"]
        if not any(float(g[k].abs().sum()) > 0 for k in ("v0", "e1", "e2")):
            raise AssertionError(f"{label}: no vertex gradient")
        texel_sum = float(g["texels"].abs().sum())
        if (texel_sum > 0) != (sc is bil):
            raise AssertionError(f"{label}: texel gradient sum {texel_sum}")
        grad_runs[label] = r
    # (c): Whitted, both K1 kernels once per level
    w_levels = whitted.render(scene, camera, DEPTH, level_kernel=False)["levels"]
    grad_runs["grad whitted"] = grad_drive(
        "grad whitted", scene, whitted_render, WHITTED_GRAD_STEPS,
        dict(closest_hit=w_levels, occluded=w_levels))

    # (d): card (kernels) against CPU (plain versions) at 64x40, one scene
    for label, small_render, radiance, rays in (
            ("path tracer", lambda sc: pt_render(sc, small, GRAD_SMALL_DEPTH)[0],
             lambda oo, dd, ss: pathtracer.sample_radiance(
                 cpu_scene, oo, dd, ss, GRAD_SMALL_DEPTH, differentiable=True)[0],
             pathtracer.camera_rays(small, GRAD_SPP, "cpu")),
            ("whitted", lambda sc: whitted_render(sc, small, GRAD_SMALL_DEPTH)[0],
             lambda oo, dd, _: whitted.radiance(
                 cpu_scene, oo, dd, GRAD_SMALL_DEPTH, differentiable=True)[0],
             (so_, sd_, None))):
        with torch.no_grad():
            img_c, img_g = small_render(cpu_scene), small_render(scene).cpu()
        mask, cmp = borderline.agreement_mask(radiance, rays, img_g, img_c)
        if cmp["unexplained"].numel():
            raise AssertionError(f"gradients 64x40 {label}: images differ at "
                                 f"{cmp['unexplained'].tolist()}")
        params = grad_mod.extract_params(cpu_scene, keys)
        grads, small_counts = {}, {}
        for where, sc in (("cuda", scene), ("cpu", cpu_scene)):
            loss_fn = grad_mod.make_loss_fn(
                sc, lambda s_, f=small_render, m=mask.to(sc.device): f(s_) * m,
                torch.zeros(img_c.shape, device=sc.device))
            (_, grads[where]), small_counts[where] = counted(
                kernels, lambda: grad_mod.value_and_grad(
                    loss_fn, {k: v.to(sc.device) for k, v in params.items()}))
        need = ["closest_hit"] + (["occluded"] if label == "whitted" else [])
        if any(small_counts["cuda"][k] == 0 for k in need) or any(
                small_counts["cuda"][k] for k in walks if k not in need):
            raise AssertionError(f"gradients 64x40 {label}: launches {small_counts['cuda']}")
        worst = {}
        for key in keys:
            want, got = grads["cpu"][key], grads["cuda"][key].cpu()
            scale = float(want.abs().max())
            excess = (got - want).abs() - GRAD_RTOL * want.abs()
            worst[key] = float(excess.max()) / scale if scale > 0 else float(excess.max())
            if not bool(torch.isfinite(got).all()) or worst[key] > GRAD_ATOL:
                raise AssertionError(f"gradients 64x40 {label}: {key} beyond atol "
                                     f"{GRAD_ATOL} max|g| + rtol {GRAD_RTOL} by {worst[key]}")
        print(f"gradients 64x40 depth {GRAD_SMALL_DEPTH} {label}, cuda vs cpu: pixels left out "
              f"(fp-borderline) {cmp['bad'].numel()}; per key, the largest excess over rtol "
              f"{GRAD_RTOL} in units of max|g| (limit {GRAD_ATOL}): "
              f"{ {k: f'{v:.3g}' for k, v in worst.items()} }; launches "
              f"{ {k: c for k, c in small_counts['cuda'].items() if c} }")

    # (e): train steps at full width, bilinear, from perturbed albedos, at
    # the target's spp_index (common random numbers)
    with torch.no_grad():
        target = pt_render(bil)[0]
    start_params = perturbed(grad_mod.extract_params(bil, ("albedo", "light_color", "texels")))
    train = make_train_step(bil, camera, target, start_params, 0.05, DEPTH, device=dev)
    losses, train_ms = [], []
    for i in range(TRAIN_STEPS):
        (loss, ms), counts = counted(kernels, lambda: timed_once(lambda: train(GRAD_SPP)))
        if counts["closest_hit"] != DEPTH + 1:
            raise AssertionError(f"train step {i}: closest_hit launched {counts['closest_hit']}")
        for key in kernels:
            launches[key] += counts[key]
        losses.append(float(loss))
        train_ms.append(ms)
    with torch.no_grad():
        final = float(grad_mod.l2_image_loss(
            pt_render(grad_mod.apply_params(bil, train.params))[0], target))
    print(f"make_train_step {WIDTH}x{HEIGHT} depth {DEPTH} bilinear, Adam lr 0.05: losses "
          f"{[f'{x:.6g}' for x in losses]}, after step {TRAIN_STEPS} {final:.6g}, ms per step "
          f"{[f'{x:.1f}' for x in train_ms]}; {card_line}")
    if not final < losses[0]:
        raise AssertionError("the train steps did not lower the loss")

    sources = dict(closest_hit=("closest_hit.cu", "ops/pallas/packet_bvh.py:442"),
                   occluded=("closest_hit.cu", "ops/pallas/packet_bvh.py:442"),
                   wavefront_pt=("wavefront_pt.cu", "ops/pallas/wavefront_pt.py:165"),
                   whitted_wf=("whitted_wf.cu", "ops/pallas/whitted_wf.py:70"),
                   closest_hit_links=("link_walk.cu", "ops/pallas/packet_bvh.py:133"),
                   occluded_links=("link_walk.cu", "ops/pallas/packet_bvh.py:133"),
                   closest_hit_wide=("wide_bvh.cu", "ops/pallas/wide_bvh.py:54"),
                   occluded_wide=("wide_bvh.cu", "ops/pallas/wide_bvh.py:54"))
    for key, count in launches.items():
        if count == 0:
            raise AssertionError(f"{key} was never launched on a main path")
    # launches per pass (the path tracer at its default wavefront_depths)
    # and per frame (Whitted's default level route) on the main scene
    default_pass = runs[pathtracer.WAVEFRONT_DEPTHS]["counts"]
    default_frame = frames[True]["counts"]
    main_launches = {key: dict(per_pass=default_pass.get(key, 0) / PASSES,
                               per_frame=default_frame.get(key, 0) / FRAMES) for key in kernels}
    # launches counted in the last timed value + grad step of the path
    # tracer (nearest) and of Whitted
    grad_launches = {key: dict(pathtracer=grad_runs["grad path tracer nearest"]["counts"][key],
                               whitted=grad_runs["grad whitted"]["counts"][key])
                     for key in kernels}
    redesigned = dict(closest_hit=5, occluded=5, closest_hit_links=5, occluded_links=5,
                      wavefront_pt=6, whitted_wf=6, closest_hit_wide=7, occluded_wide=7,
                      **{f"mxu_leaf m={m}": 7 for m in leaf_probe.WIDTHS}, vpu_leaf=8,
                      **{f"node_walk {v}": 8 for v in sync_probe.VARIANTS})
    entries = [dict(name=key, source=src, replaces=f"cpu_ray_tracer_tpu/{tpu}",
                    launches=launches[key], main=main_launches[key], result=res[key])
               for key, (src, tpu) in sources.items()]
    entries += [dict(name=key, source=src, replaces=tpu, launches=probe_launches[key],
                     main=dict(per_pass=0, per_frame=0), result=r)
                for key, src, tpu, r in probes]
    print(json.dumps({"kernels": [{
        "name": e["name"],
        "route": "cuda",
        "source": f"{PKG}/csrc/{e['source']}",
        "replaces": e["replaces"],
        "launches": e["launches"],
        "main_launches": e["main"],
        "grad_launches": grad_launches.get(e["name"], dict(pathtracer=0, whitted=0)),
        "redesigned": redesigned.get(e["name"]),
        "max_abs_err": e["result"]["max_abs_err"],
        "ms": e["result"]["ms"],
        "plain_ms": e["result"]["plain_ms"],
        "bound_ms": e["result"]["bound_ms"],
        "bound_by": e["result"]["bound_by"],
        "share": e["result"]["bound_ms"] / e["result"]["ms"],
        # no single PyTorch call computes a walk or a leaf probe; K7's
        # torch.matmul time is its product only
        "library_ms": None,
    } for e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
