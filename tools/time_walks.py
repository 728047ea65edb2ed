"""Time the PyTorch port's walk kernels on one NVIDIA GPU, on the inputs of
`chip_smoke.py` phases 3 and 3b (`bunny_teapot.xml`, 1280x720, the
`bench.py` camera), through the public wrappers only, so that one script
times two checkouts alike:

    python tools/time_walks.py [--repo DIR] [--label NAME] [--json PATH]
                               [--walks bvh,grid,kdtree,wide,fused,deep,leaf,sync]

`--repo DIR` imports `cpu_ray_tracer_tpu_torch` from another checkout (for
example the parent commit unpacked with `git archive` into a git-ignored
directory), which builds its own kernels into its own `build/`.  Run the
two in turns in one call (parent, change, change, parent) and compare only
within it.

Inputs: per accelerator (binary BVH, grid, KD tree, wide BVH) the 921,600
primary rays, the live bounce rays after the first hit in the path
tracer's launch order, and the any-hit arguments of a Whitted host-route
frame at level 0; for the binary BVH also the wavefront kernel on the
primary rays at k = 1 and at k = 6 (every depth on all 921,600 rays), and
the Whitted level kernel at levels 0 and 1 of a frame.  Closest and any
hit run on each ray set (any hit with the closest hit's t0).  Where the
checkout has it, the fused kernels also run in the camera's lane order
(`core/camera.lane_order`, 8x4 pixel tiles per warp) beside pixel order
(the Whitted kernel at level 0, the children of level 1 having no such
order); and the link walk and the stack walk run on hand-built BVHs of
140 and 100 levels (`scene/synthetic.caterpillar`, 921,600 rays of the
default camera), which a checkout that refuses them reports as refused.
Per call:
the median over 5 rounds of the mean ms of 20 launches after a warm-up
(CUDA events around the wrapper calls, `ms`), the walk kernel's own mean
device time over 20 launches (`torch.profiler`, `device_ms`),
and the mean steps and tests per ray, which must agree between checkouts.
A call on 128 rays gives the floor of a call (wrapper and launch) that
every other row stands on; the primary rays in a seeded random order give
the cost of divergence (the same rays, grouped into warps at random).
Also prints the card (nvidia-smi) and each walk kernel's registers, stack
frame and spills from the build's `-Xptxas -v` log.

`--walks` picks the rows: the four accelerators' walks, the fused kernels
(`fused`), the deep trees (`deep`), the leaf-test probes (`leaf`: K6
and K7 at every m on the probe's 64 tiles, `benchmarks/mxu_probe.inputs`,
each in the layout its checkout packs once per input) and the node-step
probe (`sync`: K8's ten variants on the 225 tiles of camera rays,
`benchmarks/sync_probe.inputs`).
The wide walk also runs its primary rays, and the any hit a Whitted
frame's level-0 shadow rays, in the camera's lane order (`perm`) where
the checkout takes one.
"""

import argparse
import copy
import json
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMERA = dict(pos=(0.0, 0.3, -1.2), target=(0.0, -0.1, 2.5))  # bench.py
WIDTH, HEIGHT, DEPTH, REPEATS, ROUNDS = 1280, 720, 5, 20, 5
WALK_KERNELS = ("closest_hit_kernel", "occluded_kernel", "closest_hit_links_kernel",
                "occluded_links_kernel", "closest_hit_wide_kernel", "occluded_wide_kernel",
                "wavefront_kernel", "whitted_kernel", "vpu_leaf_kernel",
                "mxu_leaf_kernel", "sync_probe_kernel")
ALL_WALKS = ("bvh", "grid", "kdtree", "wide", "fused", "deep", "leaf", "sync")


def ptxas_table(log: str) -> dict:
    """{kernel: {registers, stack, spill_stores, spill_loads}} of the walk
    kernels from nvcc's `-Xptxas -v` output; a template instance is named
    with its bool and int arguments (`wavefront_kernel<0,1>`: LINKS false,
    CODES true; `mxu_leaf_kernel<64>`: m)."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: |$)",
                          line)
        if entry:
            found = [k for k in WALK_KERNELS if k in entry.group(1)]
            name = max(found, key=len) if found else None
            # a template instance: its bool arguments from the mangled name
            inst = name and re.search(name + r"I((?:L[bi]\d+E)+)", entry.group(1))
            if inst:
                name += "<" + ",".join(re.findall(r"L[bi](\d+)E", inst.group(1))) + ">"
            continue
        if name is None:
            continue
        frame = re.search(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if frame:
            out.setdefault(name, {}).update(stack=int(frame.group(1)),
                                            spill_stores=int(frame.group(2)),
                                            spill_loads=int(frame.group(3)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out.setdefault(name, {})["registers"] = int(regs.group(1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=HERE, help="checkout whose port to time")
    ap.add_argument("--label", default="")
    ap.add_argument("--json", help="also write the result to this file")
    ap.add_argument("--walks", default=",".join(ALL_WALKS), help="rows to time (module docstring)")
    args = ap.parse_args()
    chosen = set(args.walks.split(","))
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import torch

    if not torch.cuda.is_available():
        print("time_walks: needs a CUDA device", file=sys.stderr)
        return 1
    from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
    from cpu_ray_tracer_tpu_torch.ops import (
        closest_hit, intersect, kernel_lib, link_walk, wavefront_pt, whitted_wf, wide_bvh,
    )
    from cpu_ray_tracer_tpu_torch.render import pathtracer, whitted
    from cpu_ray_tracer_tpu_torch.scene import query
    from cpu_ray_tracer_tpu_torch.scene.build import compile_scene

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    lib = kernel_lib.load()
    ptxas = ptxas_table(lib.build_log)
    print(card)
    for name, p in sorted(ptxas.items()):
        print(f"  {name}: {p}")
    xml = os.path.join(HERE, "assets", "scenes", "bunny_teapot.xml")
    camera = cam_mod.make_camera(WIDTH, HEIGHT, **CAMERA)
    o, d, seeds = pathtracer.camera_rays(camera, 1, dev)

    def time_ms(fn) -> float:
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        rounds = []
        for _ in range(ROUNDS):
            start.record()
            for _ in range(REPEATS):
                fn()
            end.record()
            torch.cuda.synchronize()
            rounds.append(start.elapsed_time(end) / REPEATS)
        return statistics.median(rounds)

    def device_ms(fn) -> float:
        """Mean device time per call of the walk kernel `fn()` launches, by
        the profiler: the kernel alone, whatever the host costs around it."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPEATS):
                fn()
            torch.cuda.synchronize()
        ours = [e for e in prof.key_averages() if any(k in e.key for k in WALK_KERNELS)]
        us = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                 for e in ours)
        return us / 1e3 / REPEATS

    def recorded(module, name, fn):
        """The arguments of each call of `module.<name>` while `fn()` runs."""
        orig, calls = getattr(module, name), []

        def rec(*a, **kw):
            calls.append((a, kw))
            return orig(*a, **kw)
        rec.launches = 0  # the wrapper counts through its module's name
        setattr(module, name, rec)
        try:
            fn()
        finally:
            setattr(module, name, orig)
        return calls

    def ray_sets(sc):
        t0, _ = intersect.primitive_hits(sc, o, d)
        state = pathtracer.bounce_step(sc, pathtracer.initial_state(o, d, seeds), 0, DEPTH)
        live = torch.nonzero(state["alive"]).squeeze(1)
        live = live[pathtracer.locus_order(state["d"][live], state["locus"][live])]
        bo, bd = state["o"][live].contiguous(), state["d"][live].contiguous()
        bt0, _ = intersect.primitive_hits(sc, bo, bd)
        ones = lambda x: torch.ones(x.shape[0], dtype=torch.bool, device=dev)  # noqa: E731
        # 128 rays from the middle of the frame: the time of a call whose
        # kernel has next to no work, the floor under every other row
        mid = slice(o.shape[0] // 2, o.shape[0] // 2 + 128)
        floor = (o[mid].contiguous(), d[mid].contiguous(), t0[mid].contiguous(), ones(o[mid]))
        # the primary rays in a random order: the same work, spread over
        # warps of unrelated rays; against "primary" the cost of divergence
        perm = torch.randperm(o.shape[0], generator=torch.Generator().manual_seed(0)).to(dev)
        shuffled = (o[perm], d[perm], t0[perm], ones(o))
        return {"primary": (o, d, t0, ones(o)), "primary shuffled": shuffled,
                "bounce": (bo, bd, bt0, ones(bo)), "128 rays": floor}

    walks = {"bvh": ({}, closest_hit.closest_hit, closest_hit.occluded, "occluded"),
             "grid": (dict(accel="grid"), link_walk.closest_hit_links, link_walk.occluded_links,
                      "occluded_links"),
             "kdtree": (dict(accel="kdtree"), link_walk.closest_hit_links,
                        link_walk.occluded_links, "occluded_links"),
             "wide": (dict(wide=True), wide_bvh.closest_hit_wide, wide_bvh.occluded_wide,
                      "occluded_wide")}
    rows = []
    perm = cam_mod.lane_order(camera, dev) if hasattr(cam_mod, "lane_order") else None

    def fused(kernel, fn, label, n, **extra):
        got = fn()
        add(walk="bvh", kernel=kernel, input=label, rays=n, ms=time_ms(fn),
            device_ms=device_ms(fn), steps=float(got["traversed"].float().mean()),
            tests=float(got["tested"].float().mean()), **extra)

    def fused_rows(sc):
        """The wavefront kernel (k = 1, k = 6) and the Whitted level kernel
        (levels 0 and 1) in pixel order, and in the lane order where the
        checkout has it."""
        n = o.shape[0]
        orders = [("", {})] + ([(", lane order", dict(perm=perm))] if perm is not None else [])
        for k in (1, 6):
            for olabel, okw in orders:
                def fn(k=k, okw=okw):
                    return wavefront_pt.trace(sc, o, d, seeds, k, DEPTH, **okw)
                fused("wavefront_pt", fn, f"k={k} all rays{olabel}", n,
                      live=fn()["live_counts"].tolist())
        calls = recorded(whitted_wf, "trace_level0",
                         lambda: whitted.render(sc, camera, DEPTH, True))
        for level in (0, 1):
            a, kw = calls[level]
            kw = {key: v for key, v in kw.items() if key != "perm"}
            for olabel, okw in orders if level == 0 else orders[:1]:
                def fn(a=a, kw=kw, okw=okw):
                    return whitted_wf.trace_level0(*a, **kw, **okw)
                fused("whitted_wf", fn, f"level {level}{olabel}", a[1].shape[0],
                      vis=int(fn()["vis"].sum()))

    def deep_rows():
        """The link walk on a 140-level BVH and the stack walk on a 100-level
        one (more than 64 stack entries), closest and any hit."""
        try:
            from cpu_ray_tracer_tpu_torch.scene import synthetic
        except ImportError:
            print(f"{args.label} deep trees: refused (the checkout has no such scenes)")
            return
        base, _ = compile_scene(os.path.join(HERE, "assets", "scenes", "cube_scene.xml"),
                                device="cpu")
        cam = cam_mod.make_camera(WIDTH, HEIGHT)
        for levels in (140, 100):
            sc = synthetic.scene_over(base, synthetic.caterpillar(levels)).to(dev)
            co, cd, _ = pathtracer.camera_rays(cam, 1, dev)
            ct0, _ = intersect.primitive_hits(sc, co, cd)
            mask = torch.ones(co.shape[0], dtype=torch.bool, device=dev)
            closest = query.triangle_hit
            got = closest(sc, co, cd, ct0, mask)
            label = f"deep {levels} ({sc.walk})"
            add(walk=label, kernel=f"closest ({sc.walk})", input="primary", rays=co.shape[0],
                ms=time_ms(lambda: closest(sc, co, cd, ct0, mask)),
                device_ms=device_ms(lambda: closest(sc, co, cd, ct0, mask)),
                steps=float(got["traversed"].float().mean()),
                tests=float(got["tested"].float().mean()))
            anyhit = query.triangle_occluded
            add(walk=label, kernel=f"any ({sc.walk})", input="primary", rays=co.shape[0],
                ms=time_ms(lambda: anyhit(sc, co, cd, ct0, mask)),
                device_ms=device_ms(lambda: anyhit(sc, co, cd, ct0, mask)),
                occluded=int(anyhit(sc, co, cd, ct0, mask).sum()))

    def add(**row):
        rows.append(row)
        extra = {k: v for k, v in row.items() if k not in ("walk", "kernel", "input", "rays", "ms")}
        print(f"{args.label} {row['walk']} {row['kernel']} {row['input']}: {row['rays']} rays, "
              f"{row['ms']:.4f} ms {extra}", flush=True)

    def wide_rows(sc, sets, whitted0):
        """The wide walk in pixel order and, where the checkout takes one,
        in the camera's lane order; the any hit also on the arguments of a
        Whitted host-route frame at level 0 (`whitted0`: scene, rays, t0,
        mask)."""
        import inspect

        lanes = "perm" in inspect.signature(wide_bvh.closest_hit_wide).parameters
        inputs = dict(sets)
        if lanes:
            inputs["primary, lane order"] = (*sets["primary"], perm)
        inputs.pop("128 rays")
        inputs["Whitted level 0"] = whitted0[1:]
        if lanes:
            inputs["Whitted level 0, lane order"] = (*whitted0[1:], perm)
        for label, rays in inputs.items():
            for fn in (wide_bvh.closest_hit_wide, wide_bvh.occluded_wide):
                if label.startswith("Whitted") and fn is wide_bvh.closest_hit_wide:
                    continue
                got = fn(sc, *rays)
                extra = (dict(steps=float(got["traversed"].float().mean()),
                              tests=float(got["tested"].float().mean()))
                         if isinstance(got, dict) else dict(occluded=int(got.sum())))
                add(walk="wide", kernel=fn.__name__, input=label, rays=rays[0].shape[0],
                    ms=time_ms(lambda: fn(sc, *rays)), device_ms=device_ms(lambda: fn(sc, *rays)),
                    **extra)

    def leaf_rows():
        """K6 and K7 at every m on the probe's inputs."""
        from cpu_ray_tracer_tpu_torch.benchmarks import mxu_probe
        from cpu_ray_tracer_tpu_torch.ops import leaf_probe

        inp = mxu_probe.inputs(mxu_probe.N_TILES, dev)
        n = inp["comps"][0].numel()
        fn = lambda: mxu_probe.vpu(inp)  # noqa: E731
        add(walk="leaf", kernel="vpu_leaf", input="64 tiles", rays=n, ms=time_ms(fn),
            device_ms=device_ms(fn))
        for m in leaf_probe.WIDTHS:
            c_tab, phi = inp["per_m"][m]
            fn = lambda m=m, c=c_tab, p=phi: leaf_probe.mxu_leaf(c, p, m, inp["packed"][m])  # noqa: E731
            add(walk="leaf", kernel=f"mxu_leaf m={m}", input="64 tiles", rays=n, ms=time_ms(fn),
                device_ms=device_ms(fn))

    def sync_rows():
        """K8's ten variants on the probe's camera rays."""
        from cpu_ray_tracer_tpu_torch.benchmarks import sync_probe as sync_bench
        from cpu_ray_tracer_tpu_torch.ops import sync_probe

        inp = sync_bench.inputs(sync_bench.N_TILES, dev)
        n = inp["comps"][0].numel()
        for variant in sync_probe.VARIANTS:
            fn = lambda v=variant: sync_bench.run(inp, v)  # noqa: E731
            add(walk="sync", kernel=f"node_walk {variant}", input="225 tiles", rays=n,
                ms=time_ms(fn), device_ms=device_ms(fn))

    for acc, (kwargs, closest, anyhit, query_name) in walks.items():
        if acc not in chosen:
            continue
        sc = copy.deepcopy(compile_scene(xml, device="cpu", **kwargs)[0]).to(dev)
        sets = ray_sets(sc)
        a, kw = recorded(query, query_name, lambda: whitted.render(sc, camera, DEPTH, False))[0]
        whitted0 = tuple(a[:5])  # scene and rays, without a lane order
        if acc == "wide":
            wide_rows(sc, sets, whitted0)
            sets = {"128 rays": sets["128 rays"]}
        for label, rays in sets.items():
            got = closest(sc, *rays)
            add(walk=acc, kernel=closest.__name__, input=label, rays=rays[0].shape[0],
                ms=time_ms(lambda: closest(sc, *rays)),
                device_ms=device_ms(lambda: closest(sc, *rays)),
                steps=float(got["traversed"].float().mean()),
                tests=float(got["tested"].float().mean()))
            add(walk=acc, kernel=anyhit.__name__, input=label, rays=rays[0].shape[0],
                ms=time_ms(lambda: anyhit(sc, *rays)),
                device_ms=device_ms(lambda: anyhit(sc, *rays)),
                occluded=int(anyhit(sc, *rays).sum()))
        if acc != "wide":
            add(walk=acc, kernel=anyhit.__name__, input="Whitted level 0", rays=a[1].shape[0],
                ms=time_ms(lambda: anyhit(*whitted0)),
                device_ms=device_ms(lambda: anyhit(*whitted0)),
                occluded=int(anyhit(*whitted0).sum()))
        if acc == "bvh" and "fused" in chosen:
            fused_rows(sc)
        del sc
        torch.cuda.empty_cache()
    if "deep" in chosen:
        deep_rows()
    if "leaf" in chosen:
        leaf_rows()
    if "sync" in chosen:
        sync_rows()
    result = dict(label=args.label, repo=os.path.relpath(repo, HERE), card=card,
                  device=torch.cuda.get_device_name(0), ptxas=ptxas,
                  build_seconds=lib.build_seconds, rows=rows)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
