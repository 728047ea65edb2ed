"""Time the formulations of the material-table gather on one NVIDIA GPU:
`scene/query.material_fields` reads the float fields of a ~6-row table
(albedo, reflectivity, refractivity, absorption: 8 floats) for every ray
at every depth.

    python tools/time_material_fields.py [--passes 12] [--json PATH]

On `bunny_teapot.xml` at 1280x720 with the `bench.py` camera, the material
ids of the primary hits (921,600 rays), it times four forms of the same
gather, forward alone and forward + backward (the cotangent of every
field, the table's gradient):

- `index`: `table[m]` per field, the port's forward before the gradients;
- `index_select`: `table.index_select(0, m)`, whose backward is an
  `index_add_` (atomics into the table's rows);
- `one_hot_f32`: one_hot(m) @ table in float32 (the process's default
  precision, "highest");
- `one_hot_f64`: the same product in float64, `material_fields`' form.

Then the forward host route end to end: `render_pass` at depth 5 with
`wavefront_depths=0` (six closest-hit launches a pass), in turns with
`material_fields` as the port has it and with the `index` form patched in,
`--passes` each; ms per pass (mean and median), `rays_traced`, and whether
the two images are bit-equal.  Prints the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, repeats: int) -> float:
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def forms():
    """name -> f(m [R] int64, table [M, 8]) -> [R, 8]."""
    import torch

    def one_hot(m, table, dtype):
        oh = (m[:, None] == torch.arange(table.shape[0], device=m.device)).to(dtype)
        return (oh @ table.to(dtype)).to(torch.float32)

    return {
        "index": lambda m, t: torch.cat((t[:, 0:3][m], t[:, 3][m][:, None], t[:, 4][m][:, None],
                                         t[:, 5:8][m]), dim=1),
        "index_select": lambda m, t: t.index_select(0, m),
        "one_hot_f32": lambda m, t: one_hot(m, t, torch.float32),
        "one_hot_f64": lambda m, t: one_hot(m, t, torch.float64),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, default=12)
    ap.add_argument("--repeats", type=int, default=50)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import torch

    from cpu_ray_tracer_tpu_torch.core.camera import make_camera
    from cpu_ray_tracer_tpu_torch.render import pathtracer
    from cpu_ray_tracer_tpu_torch.scene import query
    from cpu_ray_tracer_tpu_torch.scene.build import compile_scene

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    name = card()
    print(name)
    scene, _ = compile_scene(os.path.join(REPO, "assets/scenes/bunny_teapot.xml"))
    camera = make_camera(1280, 720, pos=(0.0, 0.3, -1.2), target=(0.0, -0.1, 2.5))
    o, d, _ = pathtracer.camera_rays(camera, 1)
    hit = query.find_nearest(scene, o, d)
    point = o + hit["t"][:, None] * d
    _, _, mat_id = query.get_hit_info(scene, hit, point, d)
    m = mat_id.long()
    table = torch.cat((scene.mat_albedo, scene.mat_reflectivity[:, None],
                       scene.mat_refractivity[:, None], scene.mat_absorption), dim=1)
    g = torch.randn(m.shape[0], table.shape[1], device=m.device)
    result = dict(card=name, rays=int(m.shape[0]), rows=int(table.shape[0]), gather={})
    want = table[m]
    for label, f in forms().items():
        if not torch.equal(f(m, table), want):
            raise AssertionError(f"{label}: not equal to table[m]")
        leaf = table.clone().requires_grad_()
        fwd = event_ms(lambda: f(m, table), args.repeats)
        bwd = event_ms(lambda: torch.autograd.grad(f(m, leaf), leaf, g), args.repeats)
        result["gather"][label] = dict(forward_ms=fwd, forward_backward_ms=bwd)
        print(f"{label}: forward {fwd:.4f} ms, forward + backward {bwd:.4f} ms ({name})")

    def index_fields(sc, mat_id):
        fields = query_fields(sc, mat_id)
        k = mat_id.long()
        return dict(fields, albedo=sc.mat_albedo[k], reflectivity=sc.mat_reflectivity[k],
                    refractivity=sc.mat_refractivity[k], absorption=sc.mat_absorption[k])

    query_fields = query.material_fields
    routes = {"one_hot_f64": query_fields, "index": index_fields}
    runs = {label: dict(seconds=[], rays=0) for label in routes}
    images = {}
    for label, fn in routes.items():  # warm-up
        query.material_fields = fn
        pathtracer.render_pass(scene, camera, 100, 5, 0)
    for i in range(args.passes):  # in turns: a, b, b, a, ...
        for label in (list(routes) if i % 2 == 0 else list(routes)[::-1]):
            query.material_fields = routes[label]
            torch.cuda.synchronize()
            start = time.perf_counter()
            img, stats = pathtracer.render_pass(scene, camera, i + 1, 5, 0)
            torch.cuda.synchronize()
            runs[label]["seconds"].append(time.perf_counter() - start)
            runs[label]["rays"] += stats["rays_traced"]
            if i == 0:
                images[label] = img
    query.material_fields = query_fields
    bit_equal = torch.equal(images["one_hot_f64"], images["index"])
    result["render_pass"] = {}
    for label, r in runs.items():
        s = sorted(r["seconds"])
        r = dict(passes=len(s), ms_per_pass=1e3 * sum(s) / len(s), median_ms=1e3 * s[len(s) // 2],
                 min_ms=1e3 * s[0], max_ms=1e3 * s[-1], rays_traced=r["rays"])
        result["render_pass"][label] = r
        print(f"render_pass 1280x720 depth 5 wavefront_depths=0, material fields {label}: "
              f"{r['passes']} passes, {r['ms_per_pass']:.2f} ms/pass (median {r['median_ms']:.2f}, "
              f"min {r['min_ms']:.2f}, max {r['max_ms']:.2f}), rays_traced {r['rays_traced']} "
              f"({name})")
    result["bit_equal_images"] = bit_equal
    print(f"images bit-equal: {bit_equal}")
    print(json.dumps(result))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=1)
    return 0 if bit_equal else 1


if __name__ == "__main__":
    sys.exit(main())
