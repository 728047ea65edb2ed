"""One rank of the port's ray mesh on the CPU (gloo), for
`test_torch_parallel.py`: run as a process of its own,

    python tests/torch_ranks.py RANK WORLD STORE OUT_DIR

it starts the process group over the `FileStore` at STORE, drives the
sharded render pass and the sharded train step on `cube_scene.xml` at
32x16, and saves what it saw to OUT_DIR/rank{RANK}.pt.  It imports the
port and nothing of the JAX package."""

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUBE_XML = os.path.join(REPO, "assets", "scenes", "cube_scene.xml")
W, H = 32, 16
DEPTH, LR, LR_DESCENT = 2, 1e-2, 5e-2
KEYS = ("albedo", "light_color")
TARGET = 0.25  # the constant target of tests/test_distributed.py
CRN_TARGETS = (0.25, 0.3)  # a [2, H, W, 3] stack; step 3 trains against the second


def targets():
    one = torch.full((H, W, 3), TARGET)
    stack = torch.stack([torch.full((H, W, 3), t) for t in CRN_TARGETS])
    return one, stack


def main(rank: int, world: int, store: str, out_dir: str) -> None:
    sys.path.insert(0, REPO)
    import torch.distributed as dist

    from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
    from cpu_ray_tracer_tpu_torch.diff import grad as grad_mod
    from cpu_ray_tracer_tpu_torch.diff.optimize import make_sharded_train_step
    from cpu_ray_tracer_tpu_torch.parallel import mesh as mesh_mod
    from cpu_ray_tracer_tpu_torch.parallel import sharded
    from cpu_ray_tracer_tpu_torch.render import pathtracer
    from cpu_ray_tracer_tpu_torch.scene.build import compile_scene

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    mesh = mesh_mod.make_mesh(world, device="cpu")
    out = dict(rank=mesh.rank, world=mesh.world, backend=mesh.backend)
    seen = []
    traced = pathtracer.sample_radiance

    def recording(scene, o, d, seeds, *args, **kwargs):
        seen.append(tuple(o.shape))
        return traced(scene, o, d, seeds, *args, **kwargs)

    pathtracer.sample_radiance = recording
    cam = cam_mod.make_camera(W, H)
    one, stack = targets()
    for route, kw in (("kernels", {}), ("reference", dict(use_pallas=False))):
        scene, _ = compile_scene(CUBE_XML, device="cpu", **kw)
        scene = mesh_mod.replicate_scene(scene, mesh)
        seen.clear()
        img, stats = sharded.sharded_render_pass(scene, cam, mesh)(0)
        out[f"{route}.image"], out[f"{route}.rays"] = img, stats["rays_traced"]
        out[f"{route}.traversed"] = stats["traversed"]
        out[f"{route}.shapes"] = list(seen)
    # the train steps, on the reference route (the JAX package's CPU route)
    params = grad_mod.extract_params(scene, KEYS)
    step = make_sharded_train_step(scene, cam, one, params, LR, mesh, depth_limit=DEPTH)
    out["step.loss"] = float(step(0))
    out["step.params"] = {k: v.detach().clone() for k, v in step.params.items()}
    # the all-reduced gradients the first Adam step took (a second step
    # depends on their size, not only on their sign)
    out["step.grads"] = {k: v.grad.clone() for k, v in step.params.items()}
    out["step2.loss"] = float(step(1))
    out["step2.params"] = {k: v.detach().clone() for k, v in step.params.items()}
    crn = make_sharded_train_step(scene, cam, stack, params, LR, mesh, depth_limit=DEPTH)
    out["crn.loss"] = float(crn(3))
    out["crn.params"] = {k: v.detach().clone() for k, v in crn.params.items()}
    out["crn.grads"] = {k: v.grad.clone() for k, v in crn.params.items()}
    descent = make_sharded_train_step(scene, cam, one, grad_mod.extract_params(scene, ("albedo",)),
                                      LR_DESCENT, mesh, depth_limit=DEPTH)
    out["descent"] = [float(descent(i)) for i in range(3)]
    grads = {"g": torch.full((3,), float(rank + 1))}
    out["psum"] = sharded.psum_grads(grads, mesh)["g"]
    rays = torch.arange(2 * W * H * 3, dtype=torch.float32).reshape(-1, 3)
    out["shard_rays"] = mesh_mod.shard_rays(rays, rays + 1, mesh)[0]
    try:
        sharded.sharded_render_pass(scene, cam_mod.make_camera(33, 15), mesh)
        out["odd"] = "no error"
    except ValueError as e:
        out["odd"] = str(e)
    dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
