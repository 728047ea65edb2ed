"""Progressive accumulation (the reference's Tick loop, 3. PathTracer/
renderer.cpp:144-167), as the JAX package's
`cpu_ray_tracer_tpu/render/progressive.py`: one-sample passes accumulate
into the Film, with checkpoint/resume and a metrics record a step."""

from __future__ import annotations

from cpu_ray_tracer_tpu_torch import constants
from cpu_ray_tracer_tpu_torch.core import film as film_mod
from cpu_ray_tracer_tpu_torch.core.camera import Camera
from cpu_ray_tracer_tpu_torch.core.film import Film
from cpu_ray_tracer_tpu_torch.render import pathtracer
from cpu_ray_tracer_tpu_torch.utils import checkpoint as ckpt_mod
from cpu_ray_tracer_tpu_torch.utils import metrics as metrics_mod


def render_progressive(
    scene,
    camera: Camera,
    spp: int,
    depth_limit: int = constants.DEPTH_LIMIT,
    film: Film | None = None,
    checkpoint_path: str = "",
    checkpoint_every: int = 0,
    logger: metrics_mod.JsonlLogger | None = None,
    render_fn=None,
) -> Film:
    """Accumulate on the scene's device until `film.spp == spp`, resuming
    from `film` (for instance loaded from a checkpoint).  `render_fn(scene,
    camera, pass_idx)` returns the pass's radiance [H, W, 3], or
    (radiance, stats); it defaults to `pathtracer.render_pass` at its
    defaults.  The film is saved to `checkpoint_path` whenever its sample
    count reaches a multiple of `checkpoint_every`; `logger` gets a record
    a step: the step, the film's energy, the timing and, from the stats,
    `rays_traced` and the traversal summary."""
    if film is None:
        film = film_mod.make_film(camera.height, camera.width, scene.device)
    if render_fn is None:
        def render_fn(s, c, i):
            return pathtracer.render_pass(s, c, i, depth_limit=depth_limit)

    fm = metrics_mod.FrameMetrics(camera.width, camera.height, scene.device)
    for p in range(film.spp, spp):
        fm.start()
        out = render_fn(scene, camera, p)
        radiance, stats = out if isinstance(out, tuple) else (out, {})
        timing = fm.stop()
        film = film_mod.add_samples(film, radiance, 1)
        if logger is not None:
            rec = dict(step=p + 1, energy=float(film_mod.energy(film.mean())), **timing)
            if stats:
                rec["rays_traced"] = int(stats.get("rays_traced", 0))
                rec.update(metrics_mod.traversal_summary(stats["traversed"], stats["tested"]))
            logger.log(rec)
        if checkpoint_path and checkpoint_every and (p + 1) % checkpoint_every == 0:
            ckpt_mod.save_film(checkpoint_path, film)
    return film
