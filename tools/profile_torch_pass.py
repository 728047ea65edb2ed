"""Profile the PyTorch port's main paths on one NVIDIA GPU at 1280x720,
depth 5, `bunny_teapot.xml` with the `bench.py` camera: a path-tracer pass
(`render_pass`) or a Whitted frame (`whitted.render`).

    python tools/profile_torch_pass.py [--passes 10] [--wavefront-depths K] [--json PATH]
    python tools/profile_torch_pass.py --integrator whitted [--level-kernel 0]

Prints the card, ms per pass (or frame) and rays/s over the timed passes
(after warm-up passes), and over a profiled window: the device's busy and
idle share, the port's own kernels' device time, kernel launches, the span
of each range on the device timeline (`wavefront_K` and `depth_N` of
`render/pathtracer.py`, `level_N` of `render/whitted.py`, idle gaps
included), the device time by kernel, and the host cost of one range with
the profiler off; `--json PATH` also writes the result there.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
RANGES = ("wavefront_", "depth_", "level_")
OUR_KERNELS = ("closest_hit_kernel", "occluded_kernel", "wavefront_kernel", "whitted_kernel")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
    from cpu_ray_tracer_tpu_torch.render import pathtracer, whitted
    from cpu_ray_tracer_tpu_torch.scene.build import compile_scene

    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=10)
    ap.add_argument("--integrator", choices=("pathtracer", "whitted"), default="pathtracer")
    ap.add_argument("--wavefront-depths", type=int, default=pathtracer.WAVEFRONT_DEPTHS)
    ap.add_argument("--level-kernel", type=int, choices=(0, 1), default=1)
    ap.add_argument("--json", help="also write the result to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    scene, _ = compile_scene(os.path.join(REPO, "assets", "scenes", "bunny_teapot.xml"))
    scene.to("cuda")
    camera = cam_mod.make_camera(1280, 720, pos=(0.0, 0.3, -1.2), target=(0.0, -0.1, 2.5))
    if args.integrator == "pathtracer":
        config = f"wavefront_depths={args.wavefront_depths}"

        def run(p):
            _, stats = pathtracer.render_pass(scene, camera, p, wavefront_depths=args.wavefront_depths)
            return stats["rays_traced"]
    else:
        config = f"level_kernel={bool(args.level_kernel)}"

        def run(p):
            return whitted.render(scene, camera, level_kernel=bool(args.level_kernel))["rays"]

    for p in range(3):  # warm-up: kernel build, allocator, library handles
        run(100 + p)
    torch.cuda.synchronize()
    rays = 0
    start = time.perf_counter()
    for p in range(args.passes):
        rays += run(p + 1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start

    probes = 10000
    start = time.perf_counter()
    for _ in range(probes):
        with torch.profiler.record_function("depth_probe"):
            pass
    range_us = 1e6 * (time.perf_counter() - start) / probes

    window = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = time.perf_counter()
        for p in range(window):
            run(p + 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall
    averages = prof.key_averages()
    on_device = [e for e in averages if e.device_type == DeviceType.CUDA]
    # the ranges show on the device timeline as spans around their kernels;
    # kernels alone make the busy time
    spans = {e.key: _device_us(e) for e in on_device if e.key.startswith(RANGES)}
    kernels = sorted(
        (e for e in on_device if e.key not in spans), key=lambda e: -_device_us(e)
    )
    busy_us = sum(_device_us(e) for e in kernels)
    ours = {
        name: sum(_device_us(e) for e in kernels if name in e.key) / 1e3 / window
        for name in OUR_KERNELS
    }
    result = dict(
        card=card,
        integrator=args.integrator,
        config=config,
        passes=args.passes,
        ms_per_pass=1e3 * seconds / args.passes,
        rays_per_pass=rays / args.passes,
        rays_per_s=rays / seconds,
        profiled_passes=window,
        profiled_wall_ms_per_pass=1e3 * wall / window,
        device_busy_ms_per_pass=busy_us / 1e3 / window,
        device_idle_share=1.0 - busy_us / 1e6 / wall,
        our_kernels_ms_per_pass={k: v for k, v in ours.items() if v},
        kernel_launches_per_pass=sum(e.count for e in kernels) / window,
        record_function_host_us_profiler_off=range_us,
        device_span_ms_per_pass_by_range={k: us / 1e3 / window for k, us in sorted(spans.items())},
        device_ms_per_pass_by_kernel=[
            (e.key[:90], _device_us(e) / 1e3 / window, e.count // window) for e in kernels[:20]
        ],
    )
    print(card)
    print(json.dumps(result, indent=1))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
