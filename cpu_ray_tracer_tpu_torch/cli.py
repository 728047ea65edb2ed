"""Command-line renderer of the PyTorch port, as the JAX package's
`cpu_ray_tracer_tpu/cli.py` (the headless driver replacing the
reference's GLFW main loop, template/template.cpp:83-359), with the flags
of `utils/config.RenderConfig`; `--device cpu` renders with the plain
PyTorch versions of the kernels:

    python -m cpu_ray_tracer_tpu_torch.cli --scene-xml assets/scenes/bunny_teapot.xml \\
        --integrator pathtracer --spp 16 --width 640 --height 360 --out out.png

`--sharded true` splits each path-tracer pass's pixels over the ranks of a
ray mesh (`parallel/`), one process a device: under `torchrun
--nproc-per-node N ... --sharded true --n-devices N` (`--n-devices` 0 or
absent: the launcher's world; without a launcher a world of one).  Every
rank renders its block, and only rank 0 writes the PNG, the metrics and
the checkpoint.  As in the JAX package's CLI, Whitted and basics frames
are not split.  The first JSONL record states what ran
(`utils/metrics.runtime_flags`, and the world size under `--sharded`).
"""

from __future__ import annotations

import os
import sys


def main(argv=None) -> int:
    from cpu_ray_tracer_tpu_torch.utils.config import parse_args

    cfg = parse_args(argv)
    if not cfg.scene_xml:
        print("--scene-xml is required", file=sys.stderr)
        return 2
    mesh = None
    if cfg.sharded:
        from cpu_ray_tracer_tpu_torch.parallel.mesh import make_mesh

        # first, so that each rank's "cuda" is its own card
        mesh = make_mesh(cfg.n_devices or None, device=cfg.device)
    try:
        return _render(cfg, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def _render(cfg, mesh) -> int:
    from cpu_ray_tracer_tpu_torch.core import film as film_mod
    from cpu_ray_tracer_tpu_torch.io.image import write_png
    from cpu_ray_tracer_tpu_torch.utils import checkpoint as ckpt_mod
    from cpu_ray_tracer_tpu_torch.utils import metrics as metrics_mod

    scene, info = cfg.build_scene()
    camera = cfg.build_camera()
    print(
        f"scene '{info.name}': {info.triangle_count} tris, "
        f"{info.object_count} objects, build {info.build_time_us} us, "
        f"max depth {info.max_tree_depth}, accel={cfg.accel} layout={cfg.layout}"
    )
    if mesh is not None:
        from cpu_ray_tracer_tpu_torch.parallel.mesh import replicate_scene

        scene = replicate_scene(scene, mesh)
    lead = mesh is None or mesh.rank == 0  # the rank that writes the files
    logger = metrics_mod.JsonlLogger(cfg.metrics_jsonl if lead else "")
    flags = metrics_mod.runtime_flags(scene.device, info)
    if mesh is not None:
        flags["world"] = mesh.world
    logger.log(dict(runtime=flags))
    try:
        if cfg.integrator == "basics":
            from cpu_ray_tracer_tpu_torch.render import basics

            img = basics.render(scene, camera, aov=cfg.aov)
        elif cfg.integrator == "whitted":
            from cpu_ray_tracer_tpu_torch.render import whitted

            fm = metrics_mod.FrameMetrics(cfg.width, cfg.height, scene.device)
            fm.start()
            # children are gathered exactly: nothing is dropped at any cap
            # factor, so the frame renders once whatever --whitted-grow-cap
            out = whitted.render_adaptive(scene, camera, depth_limit=cfg.depth_limit,
                                          cap_factor=cfg.whitted_cap_factor)
            timing = fm.stop()
            rec = dict(**timing, **metrics_mod.traversal_summary(out["traversed"], out["tested"]))
            print(rec)
            logger.log(rec)
            img = out["image"]
        else:
            from cpu_ray_tracer_tpu_torch.render import progressive

            film = None
            if cfg.checkpoint and os.path.exists(cfg.checkpoint):
                film, _ = ckpt_mod.load_film(cfg.checkpoint, scene.device)
                print(f"resumed from {cfg.checkpoint} at spp={film.spp}")
            render_fn = None
            if mesh is not None:
                from cpu_ray_tracer_tpu_torch.parallel.sharded import sharded_render_pass

                run = sharded_render_pass(scene, camera, mesh, depth_limit=cfg.depth_limit)
                render_fn = lambda s, c, i: run(i)  # noqa: E731
            film = progressive.render_progressive(
                scene,
                camera,
                cfg.spp,
                depth_limit=cfg.depth_limit,
                film=film,
                checkpoint_path=cfg.checkpoint if lead else "",
                checkpoint_every=cfg.checkpoint_every,
                logger=logger,
                render_fn=render_fn,
            )
            img = film.mean()
            print(f"energy: {float(film_mod.energy(img)):.1f} at spp={film.spp}")

        if lead:
            write_png(cfg.out, film_mod.to_rgb8(img).cpu().numpy())
            print(f"wrote {cfg.out}")
    finally:
        logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
