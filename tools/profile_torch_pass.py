"""Profile the PyTorch port's main paths on one NVIDIA GPU at 1280x720,
depth 5, `bunny_teapot.xml` with the `bench.py` camera: a path-tracer pass
(`render_pass`) or a Whitted frame (`whitted.render`), over the binary BVH
or another accelerator (`--accel grid|kdtree`, `--wide 1|bounce`).

    python tools/profile_torch_pass.py [--passes 10] [--wavefront-depths K] [--json PATH]
    python tools/profile_torch_pass.py --integrator whitted [--level-kernel 0]
    python tools/profile_torch_pass.py --accel grid [--integrator whitted]
    python tools/profile_torch_pass.py --wide bounce
    python tools/profile_torch_pass.py --grad [--bilinear] [--integrator whitted]

The route options default to the scene's own (`compile_scene`'s README
entry): the kernels on the binary BVH, the host route elsewhere.

`--grad` profiles a value + grad step instead of a pass or frame: the
differentiable render (`render_pass` or `whitted.render` with
`differentiable=True`, the host route) of the scene with every key of
`diff/grad.PARAM_KEYS` swapped in, the L2 loss against a target rendered
at the same `spp_index` from perturbed parameters (albedo x0.8, light
colour x0.9), and the gradient of every key.  ms per step, rays/s
counted from the forward's rays (`rays_traced`, or Whitted's `rays`) as
`bench_fwdbwd.py` counts them, the peak of `torch.cuda.max_memory_allocated`,
and, beside the step's profile, a profile of the backward alone (three
forwards run first, then their three backwards are profiled): its device
busy ms and its top device operations.

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
OUR_KERNELS = ("closest_hit_kernel", "occluded_kernel", "closest_hit_links_kernel",
               "occluded_links_kernel", "closest_hit_wide_kernel", "occluded_wide_kernel",
               "wavefront_kernel", "whitted_kernel")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def device_kernels(prof, device_type):
    """(spans of the ranges, kernels by device time, busy us) of a
    profile: the ranges show on the device timeline as spans around their
    kernels; kernels alone make the busy time."""
    on_device = [e for e in prof.key_averages() if e.device_type == device_type.CUDA]
    spans = {e.key: _device_us(e) for e in on_device if e.key.startswith(RANGES)}
    kernels = sorted((e for e in on_device if e.key not in spans), key=lambda e: -_device_us(e))
    return spans, kernels, sum(_device_us(e) for e in kernels)


def grad_step(scene, camera, integrator: str, spp_index: int = 1):
    """(forward() -> (loss, rays), backward(loss)) of a value + grad step
    over every key of PARAM_KEYS at `spp_index` (module docstring)."""
    import torch

    from cpu_ray_tracer_tpu_torch.diff import grad as grad_mod
    from cpu_ray_tracer_tpu_torch.render import pathtracer, whitted

    params = grad_mod.extract_params(scene, grad_mod.PARAM_KEYS)

    def render(sc):
        if integrator == "pathtracer":
            img, stats = pathtracer.render_pass(sc, camera, spp_index, differentiable=True)
            return img, stats["rays_traced"]
        out = whitted.render(sc, camera, differentiable=True)
        return out["image"], out["rays"]

    perturbed = dict(params, albedo=params["albedo"] * 0.8,
                     light_color=params["light_color"] * 0.9)
    with torch.no_grad():
        target = render(grad_mod.apply_params(scene, perturbed))[0]

    def forward():
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        img, rays = render(grad_mod.apply_params(scene, leaves))
        return (grad_mod.l2_image_loss(img, target), list(leaves.values())), rays

    def backward(loss):
        torch.autograd.grad(loss[0], loss[1], allow_unused=True)

    return forward, backward


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
    ap.add_argument("--accel", choices=("bvh", "grid", "kdtree"), default="bvh")
    ap.add_argument("--wide", choices=("0", "1", "bounce"), default="0")
    ap.add_argument("--wavefront-depths", type=int, default=None)
    ap.add_argument("--level-kernel", type=int, choices=(0, 1), default=None)
    ap.add_argument("--grad", action="store_true", help="profile a value + grad step")
    ap.add_argument("--bilinear", action="store_true", help="the bilinear texture tap")
    ap.add_argument("--json", help="also write the result to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    wide = dict(zip(("0", "1", "bounce"), (False, True, "bounce")))[args.wide]
    scene, _ = compile_scene(os.path.join(REPO, "assets", "scenes", "bunny_teapot.xml"),
                             accel=args.accel, wide=wide, bilinear=args.bilinear, device="cuda")
    camera = cam_mod.make_camera(1280, 720, pos=(0.0, 0.3, -1.2), target=(0.0, -0.1, 2.5))
    level_kernel = None if args.level_kernel is None else bool(args.level_kernel)
    backward = None
    if args.grad:
        config = f"accel={args.accel} wide={wide} bilinear={args.bilinear} grad {args.integrator}"
        forward, backward = grad_step(scene, camera, args.integrator)

        def run(_):
            loss, rays = forward()
            backward(loss)
            return rays
    elif args.integrator == "pathtracer":
        depths = pathtracer.wavefront_depths_for(scene, args.wavefront_depths)
        config = f"accel={args.accel} wide={wide} wavefront_depths={depths}"

        def run(p):
            _, stats = pathtracer.render_pass(scene, camera, p, wavefront_depths=depths)
            return stats["rays_traced"]
    else:
        level_kernel = whitted.level_kernel_for(scene, level_kernel)
        config = f"accel={args.accel} wide={wide} level_kernel={level_kernel}"

        def run(p):
            return whitted.render(scene, camera, level_kernel=level_kernel)["rays"]

    for p in range(3):  # warm-up: kernel build, allocator, library handles
        run(100 + p)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
    spans, kernels, busy_us = device_kernels(prof, DeviceType)
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
    if backward is not None:
        result["peak_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        losses = [forward()[0] for _ in range(window)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = time.perf_counter()
            for loss in losses:
                backward(loss)
            torch.cuda.synchronize()
            wall = time.perf_counter() - wall
        _, bwd, bwd_us = device_kernels(prof, DeviceType)
        result.update(
            backward_wall_ms_per_step=1e3 * wall / window,
            backward_device_busy_ms_per_step=bwd_us / 1e3 / window,
            backward_kernel_launches_per_step=sum(e.count for e in bwd) / window,
            backward_device_ms_per_step_by_kernel=[
                (e.key[:90], _device_us(e) / 1e3 / window, e.count // window) for e in bwd[:20]
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
