"""Command-line renderer of the PyTorch port, as the JAX package's
`cpu_ray_tracer_tpu/cli.py` (the headless driver replacing the
reference's GLFW main loop, template/template.cpp:83-359), with the flags
of `utils/config.RenderConfig`; `--device cpu` renders with the plain
PyTorch versions of the kernels:

    python -m cpu_ray_tracer_tpu_torch.cli --scene-xml assets/scenes/bunny_teapot.xml \\
        --integrator pathtracer --spp 16 --width 640 --height 360 --out out.png
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
    if cfg.sharded:
        raise NotImplementedError("--sharded: multi-device rendering is not ported "
                                  "(ROADMAP queue 1, item 14)")

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
    logger = metrics_mod.JsonlLogger(cfg.metrics_jsonl)
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
            film = progressive.render_progressive(
                scene,
                camera,
                cfg.spp,
                depth_limit=cfg.depth_limit,
                film=film,
                checkpoint_path=cfg.checkpoint,
                checkpoint_every=cfg.checkpoint_every,
                logger=logger,
            )
            img = film.mean()
            print(f"energy: {float(film_mod.energy(img)):.1f} at spp={film.spp}")

        write_png(cfg.out, film_mod.to_rgb8(img).cpu().numpy())
        print(f"wrote {cfg.out}")
    finally:
        logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
