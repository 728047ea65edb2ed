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
   path tracer on the 921,600 primary rays with k = 1 and on 65,536 of
   them with k = 6; the Whitted level kernel and the any hit on the
   arguments that a Whitted frame passes them at levels 0 and 1 (recorded
   from a render through each level route: the level kernel's `inside`,
   the host route's shadow query over every ray of a level, masked to the
   diffuse hits).  Integers exact, floats within 1e-6 relative; times of
   both;
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

Each drive of a main path (one pass or one frame) sets every kernel's
launch count to 0 just before it and reads the counts just after; every
kernel of the path must have launched.
The line before the last is `{"kernels": [...]}`; the last line is
`{"ok": true, "device": {...}}`.
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
WAVEFRONT_DEPTHS = (0, 1, 6)
KERNEL_REPEATS = 20
PKG = "cpu_ray_tracer_tpu_torch"


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


def compare(name: str, label: str, kernel, plain, n: int) -> dict:
    """`kernel()` against `plain()` on the card: every integer and bool
    output exact, every float within 1e-6 relative; both timed."""
    import torch

    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    torch.cuda.synchronize()
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
    plain_ms = time_cuda(plain, 1)
    print(f"{name} {label}: {n} rays, integers exact, bitwise float mismatches {bitwise}, "
          f"max abs err {max_err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.1f} ms")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, got=got)


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
    from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
    from cpu_ray_tracer_tpu_torch.ops import intersect, kernel_lib, wavefront_pt, whitted_wf
    from cpu_ray_tracer_tpu_torch.ops.closest_hit import (
        closest_hit, closest_hit_plain, occluded, occluded_plain,
    )
    from cpu_ray_tracer_tpu_torch.render import borderline, pathtracer, whitted
    from cpu_ray_tracer_tpu_torch.scene import query
    from cpu_ray_tracer_tpu_torch.scene.build import compile_scene

    kernels = dict(closest_hit=closest_hit, occluded=occluded,
                   wavefront_pt=wavefront_pt.trace, whitted_wf=whitted_wf.trace_level0)
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(card())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}")

    # --- 2. build ----------------------------------------------------------
    k = kernel_lib.load()
    print(f"kernel library built in {k.build_seconds:.1f} s: {os.path.relpath(k.path, REPO)}")
    for line in k.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  nvcc: {line.strip()}")

    # --- 3. each kernel against its plain version, main-path inputs --------
    start = time.perf_counter()
    cpu_scene, info = compile_scene(XML)
    print(f"scene: {info}, compiled in {time.perf_counter() - start:.2f} s")
    scene = copy.deepcopy(cpu_scene).to(dev)
    camera = cam_mod.make_camera(WIDTH, HEIGHT, **CAMERA)
    o, d, seeds = pathtracer.camera_rays(camera, 1, dev)
    t0, _ = intersect.primitive_hits(scene, o, d)
    n = o.shape[0]
    res = {}
    res["closest_hit"] = compare("closest_hit", "primary", lambda: closest_hit(scene, o, d, t0),
                                 lambda: closest_hit_plain(scene, o, d, t0), n)
    state = pathtracer.bounce_step(scene, pathtracer.initial_state(o, d, seeds), 0, DEPTH)
    live = torch.nonzero(state["alive"]).squeeze(1)
    live = live[pathtracer.locus_order(state["d"][live], state["locus"][live])]
    bo, bd = state["o"][live].contiguous(), state["d"][live].contiguous()
    bt0, _ = intersect.primitive_hits(scene, bo, bd)
    compare("closest_hit", "bounce", lambda: closest_hit(scene, bo, bd, bt0),
            lambda: closest_hit_plain(scene, bo, bd, bt0), bo.shape[0])
    res["wavefront_pt"] = compare(
        "wavefront_pt", "k=1 primary", lambda: wavefront_pt.trace(scene, o, d, seeds, 1, DEPTH),
        lambda: wavefront_pt.trace_plain(scene, o, d, seeds, 1, DEPTH), n)
    m = 65536  # every 14th primary ray: the whole frame, not its top rows of sky
    so6, sd6, ss6 = (x[::14][:m].contiguous() for x in (o, d, seeds))
    wf6 = compare(
        "wavefront_pt", "k=6 primary[::14][:65536]",
        lambda: wavefront_pt.trace(scene, so6, sd6, ss6, 6, DEPTH),
        lambda: wavefront_pt.trace_plain(scene, so6, sd6, ss6, 6, DEPTH), m)
    print(f"  k=6 live counts {wf6['got']['live_counts'].tolist()}")
    # the Whitted level kernel and the any hit on the arguments the two
    # Whitted routes pass them at levels 0 and 1 (level 1's refracted rays
    # carry `inside`; the host route's shadow query takes every ray of a
    # level with the diffuse hits as its mask)
    wf_calls = recorded(whitted_wf, "trace_level0",
                        lambda: whitted.render(scene, camera, DEPTH, True))
    occ_calls = recorded(query, "occluded", lambda: whitted.render(scene, camera, DEPTH, False))
    for key, kernel, plain, calls in (
        ("whitted_wf", whitted_wf.trace_level0, whitted_wf.trace_level0_plain, wf_calls),
        ("occluded", occluded, occluded_plain, occ_calls),
    ):
        for level in (0, 1):
            args, kwargs = calls[level]
            r = compare(key, f"Whitted level {level}", lambda f=kernel: f(*args, **kwargs),
                        lambda f=plain: f(*args, **kwargs), args[1].shape[0])
            if key == "whitted_wf":
                print(f"  inside {int(args[3].sum())}, diffuse surfaces lit "
                      f"{int(r['got']['vis'].sum())}")
            else:
                print(f"  mask {int(args[4].sum())}, occluded {int(r['got']['out'].sum())}")
            if level == 0:
                res[key] = r
            else:
                res[key]["max_abs_err"] = max(res[key]["max_abs_err"], r["max_abs_err"])
    wo, wd = cam_mod.full_frame_rays(camera, device=dev)

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

    # --- 6. card (kernels) against CPU (plain versions) ----------------------
    small = cam_mod.make_camera(64, 40, **CAMERA)
    for kd in (0, 1):
        img_gpu, st_gpu = pathtracer.render_pass(scene, small, 1, DEPTH, kd)
        img_cpu, st_cpu = pathtracer.render_pass(cpu_scene, small, 1, DEPTH, kd)
        cmp = borderline.unexplained_pixels(
            lambda oo, dd, ss, kd=kd: pathtracer.sample_radiance(cpu_scene, oo, dd, ss, DEPTH, kd)[0],
            pathtracer.camera_rays(small, 1), img_gpu.cpu(), img_cpu)
        print(
            f"render_pass 64x40 wavefront_depths={kd} cuda vs cpu: rays_traced "
            f"{st_gpu['rays_traced']} vs {st_cpu['rays_traced']}, pixels beyond tolerance "
            f"{cmp['bad'].numel()} {cmp['bad'].tolist()}, not fp-borderline {cmp['unexplained'].numel()}"
        )
        if st_gpu["rays_traced"] != st_cpu["rays_traced"] or cmp["unexplained"].numel():
            raise AssertionError("the card's render differs from the CPU's")
    w_gpu = whitted.render(scene, small, DEPTH)["image"].cpu()
    w_cpu = whitted.render(cpu_scene, small, DEPTH)["image"]
    so_, sd_ = cam_mod.full_frame_rays(small)
    cmp = borderline.unexplained_pixels(
        lambda oo, dd, _: whitted.radiance(cpu_scene, oo, dd, DEPTH)[0], (so_, sd_, None),
        w_gpu, w_cpu)
    print(f"whitted 64x40 cuda vs cpu: pixels beyond tolerance {cmp['bad'].numel()}, "
          f"not fp-borderline {cmp['unexplained'].numel()}")
    if cmp["unexplained"].numel():
        raise AssertionError("the card's Whitted render differs from the CPU's")

    sources = dict(closest_hit=("closest_hit.cu", "ops/pallas/packet_bvh.py:442"),
                   occluded=("closest_hit.cu", "ops/pallas/packet_bvh.py:442"),
                   wavefront_pt=("wavefront_pt.cu", "ops/pallas/wavefront_pt.py:165"),
                   whitted_wf=("whitted_wf.cu", "ops/pallas/whitted_wf.py:70"))
    for key, count in launches.items():
        if count == 0:
            raise AssertionError(f"{key} was never launched on a main path")
    print(json.dumps({"kernels": [{
        "name": key,
        "route": "cuda",
        "source": f"{PKG}/csrc/{src}",
        "replaces": f"cpu_ray_tracer_tpu/{tpu}",
        "launches": launches[key],
        "max_abs_err": res[key]["max_abs_err"],
        "ms": res[key]["ms"],
        "plain_ms": res[key]["plain_ms"],
    } for key, (src, tpu) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
