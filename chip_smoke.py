#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`cpu_ray_tracer_tpu_torch`) on one NVIDIA
GPU.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from `cpu_ray_tracer_tpu_torch/csrc/`;
3. the closest-hit kernel against `closest_hit_plain` on the card, on the
   main path's inputs: the 1280x720 primary rays of `bunny_teapot.xml`
   and the live bounce rays after their first hit, in the order the path
   tracer launches them.  Ids and counters exact, t/u/v within 1e-6
   relative; times of both;
4. the main path: `compile_scene` -> `render_pass` at 1280x720, depth 5,
   the `bench.py` camera, 16 passes; ms per pass, rays traced, rays/s, the
   film's energy; the kernel must have been launched, the image finite and
   non-zero;
5. a 64x40 render on the card (kernel) against one on the CPU (plain
   versions): `rays_traced` exact, image allclose at the JAX package's
   parity tolerance except where a pixel is fp-borderline
   (`render/borderline.py`).

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
WIDTH, HEIGHT, DEPTH, PASSES = 1280, 720, 5, 16
KERNEL_REPEATS = 20


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


def compare_closest_hit(scene, o, d, t0, label: str) -> dict:
    """Kernel against the plain version on the same card tensors."""
    import torch

    from cpu_ray_tracer_tpu_torch.ops.closest_hit import closest_hit, closest_hit_plain

    got = closest_hit(scene, o, d, t0)
    torch.cuda.synchronize()
    want = closest_hit_plain(scene, o, d, t0)
    torch.cuda.synchronize()
    for key in ("slot", "tri_idx", "obj_id", "mat_id", "traversed", "tested"):
        bad = int((got[key] != want[key]).sum())
        if bad:
            raise AssertionError(f"{label}: {key} differs on {bad} of {o.shape[0]} rays")
    max_err, bitwise = 0.0, 0
    for key in ("t", "u", "v"):
        diff = (got[key] - want[key]).abs()
        bitwise += int((got[key].view(torch.int32) != want[key].view(torch.int32)).sum())
        if bool((diff > 1e-6 * want[key].abs()).any()):
            raise AssertionError(f"{label}: {key} beyond 1e-6 relative, max {float(diff.max())}")
        max_err = max(max_err, float(diff.max()))
    ms = time_cuda(lambda: closest_hit(scene, o, d, t0), KERNEL_REPEATS)
    plain_ms = time_cuda(lambda: closest_hit_plain(scene, o, d, t0), 1)
    hits = int((got["tri_idx"] >= 0).sum())
    print(
        f"closest_hit {label}: {o.shape[0]} rays, {hits} triangle hits, ids and counters "
        f"exact, bitwise t/u/v mismatches {bitwise}, max abs err {max_err:.3g}, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, "
        f"mean steps {float(got['traversed'].float().mean()):.2f}, "
        f"mean tests {float(got['tested'].float().mean()):.2f}"
    )
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU fallback here", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
    from cpu_ray_tracer_tpu_torch.ops import kernel_lib
    from cpu_ray_tracer_tpu_torch.ops.closest_hit import closest_hit
    from cpu_ray_tracer_tpu_torch.render import borderline, pathtracer
    from cpu_ray_tracer_tpu_torch.scene import query
    from cpu_ray_tracer_tpu_torch.scene.build import compile_scene

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(card())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}")

    # --- 2. build ----------------------------------------------------------
    k = kernel_lib.load()
    print(f"kernel library built in {k.build_seconds:.1f} s: {os.path.relpath(k.path, REPO)}")
    for line in k.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  nvcc: {line.strip()}")

    # --- 3. kernel against its plain version, main-path inputs -------------
    start = time.perf_counter()
    cpu_scene, info = compile_scene(XML)
    print(f"scene: {info}, compiled in {time.perf_counter() - start:.2f} s")
    scene = copy.deepcopy(cpu_scene).to(dev)
    camera = cam_mod.make_camera(WIDTH, HEIGHT, **CAMERA)
    o, d, seeds = pathtracer.camera_rays(camera, 1, dev)
    t0, _ = query.primitive_hits(scene, o, d)
    primary = compare_closest_hit(scene, o, d, t0, "primary")
    state = pathtracer.bounce_step(scene, pathtracer.initial_state(o, d, seeds), 0, DEPTH)
    live = torch.nonzero(state["alive"]).squeeze(1)
    live = live[pathtracer.locus_order(state["d"][live], state["locus"][live])]
    bo, bd = state["o"][live].contiguous(), state["d"][live].contiguous()
    bt0, _ = query.primitive_hits(scene, bo, bd)
    compare_closest_hit(scene, bo, bd, bt0, "bounce")

    # --- 4. the main path ----------------------------------------------------
    closest_hit.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    film = torch.zeros((HEIGHT, WIDTH, 3), dtype=torch.float32, device=dev)
    rays = 0
    for p in range(PASSES):
        img, stats = pathtracer.render_pass(scene, camera, p + 1, DEPTH)
        if img.shape != film.shape:
            raise AssertionError(f"render_pass returned shape {tuple(img.shape)}")
        film += img
        rays += stats["rays_traced"]
    energy = float(film.sum()) / PASSES
    seconds = time.perf_counter() - start
    launches = closest_hit.launches
    if launches == 0:
        raise AssertionError("the render never launched the closest-hit kernel")
    if not bool(torch.isfinite(film).all()) or energy <= 0.0:
        raise AssertionError(f"bad film: energy {energy}")
    print(
        f"render_pass {WIDTH}x{HEIGHT} depth {DEPTH}: {PASSES} passes, "
        f"{1e3 * seconds / PASSES:.1f} ms/pass, rays_traced {rays}, "
        f"{rays / seconds:.4g} rays/s, energy {energy:.6g}, kernel launches {launches}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )

    # --- 5. card (kernel) against CPU (plain versions) -----------------------
    small = cam_mod.make_camera(64, 40, **CAMERA)
    img_gpu, st_gpu = pathtracer.render_pass(scene, small, 1, DEPTH)
    img_cpu, st_cpu = pathtracer.render_pass(cpu_scene, small, 1, DEPTH)
    img_gpu = img_gpu.cpu()
    cmp = borderline.unexplained_pixels(cpu_scene, small, 1, img_gpu, img_cpu, DEPTH)
    print(
        f"render_pass 64x40 cuda vs cpu: rays_traced {st_gpu['rays_traced']} vs "
        f"{st_cpu['rays_traced']}, max abs diff {float((img_gpu - img_cpu).abs().max()):.3g}, "
        f"pixels beyond tolerance {cmp['bad'].numel()} (flat indices {cmp['bad'].tolist()}), "
        f"of which not fp-borderline under an eps nudge: {cmp['unexplained'].numel()}"
    )
    if st_gpu["rays_traced"] != st_cpu["rays_traced"] or cmp["unexplained"].numel():
        raise AssertionError("the card's render differs from the CPU's")

    print(json.dumps({"kernels": [{
        "name": "closest_hit",
        "route": "cuda",
        "source": "cpu_ray_tracer_tpu_torch/csrc/closest_hit.cu",
        "replaces": "cpu_ray_tracer_tpu/ops/pallas/packet_bvh.py:442",
        "launches": launches,
        "max_abs_err": primary["max_abs_err"],
        "ms": primary["ms"],
        "plain_ms": primary["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
