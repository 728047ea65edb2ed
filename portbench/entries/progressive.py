"""Back-to-back images of `spp` samples a pixel, each one call of the
program's `render/progressive.render_progressive` at depth `depth` on a
fresh film, with a logger of the benchmark's own; an iteration is one
progressive step (one pass), timed from the logger's records.  Each image
takes the next of `orbit_views` views evenly spaced on the orbit, the
seed choosing the first: every seed renders the same views, in another
order.

Parameters: `width`, `height`, `spp`, `depth`, `orbit` (`lib/scenario.py`),
`orbit_views`, `check_pixels` (the film's pixels the check draws),
`trace_units` (images in a traced window)."""

from __future__ import annotations

import math

import numpy as np

from portbench.lib import faults, scenario, traffic

FAULTS = ("unchanged", "half", "answer")


def plant(fault: str, patch):
    """`unchanged`: the film's sum returns the film as it was; `half`: every
    other column of a pass left out, the rest doubled; `answer`: a pass's
    radiance times 1.01."""
    from cpu_ray_tracer_tpu_torch.core import film as film_mod
    from cpu_ray_tracer_tpu_torch.render import pathtracer

    if fault == "unchanged":
        patch(film_mod, "add_samples",
              lambda film, radiance, n: film_mod.Film(accum=film.accum, spp=film.spp + n))
        return
    render_pass = pathtracer.render_pass

    def altered(*args, **kwargs):
        img, stats = render_pass(*args, **kwargs)
        return (faults.drop_half(img) if fault == "half" else img * 1.01), stats

    patch(pathtracer, "render_pass", altered)


class Loop(traffic.Entry):
    def __init__(self, run):
        from cpu_ray_tracer_tpu_torch.core.camera import make_camera

        super().__init__(run)
        p = self.params
        self.spp, self.depth = p["spp"], p["depth"]
        turn = p["orbit_views"]
        self.views = [scenario.orbit(2 * math.pi * k / turn, **p["orbit"]) for k in range(turn)]
        self.cameras = [make_camera(run.width, run.height, pos=a, target=b) for a, b in self.views]
        # the view of the first image; the check's pass is one of that image's
        self.start = int(run.inputs.integers(turn))
        # the check's draws: the pass it traces whole, the pixels of the film
        self.pass_index = int(run.draws.integers(self.spp))
        n = run.width * run.height
        self.pixels = np.sort(run.draws.choice(n, min(p["check_pixels"], n), replace=False))
        self.images, self.film, self.film_view = [], None, self.start

    def unit(self) -> list:
        from cpu_ray_tracer_tpu_torch.render import progressive

        view = (self.start + len(self.images)) % len(self.cameras)
        log = traffic.StepLog()
        self.film = progressive.render_progressive(self.run.scene, self.cameras[view], self.spp,
                                                   depth_limit=self.depth, logger=log)
        self.film_view = view
        self.images.append((view, [(r["rays_traced"], r["energy"]) for r in log.records]))
        # a pass traces every depth to the limit: its rays never all end sooner
        return [(t, r["rays_traced"], self.depth + 1) for t, r in zip(log.times, log.records)]

    def release(self):
        """Drop the program's state (the check needs only the answers)."""
        self.run.scene, self.film = None, None

    def answers(self) -> dict:
        """The outputs the check reads: the pool, the last image's film at
        the drawn pixels and its view, the first image's drawn pass's rays
        and energy (a record's energy is the film's mean summed, so a
        pass's is the difference of two records times their sample
        counts), and how many records of later images differ from those of
        the first image of their view."""
        import torch

        firsts = {}
        for view, img in self.images:
            firsts.setdefault(view, img)
        mismatches = sum(rec != firsts[view][k] for view, img in self.images
                         for k, rec in enumerate(img))
        first = self.images[0][1]
        k = self.pass_index
        energy = first[k][1] * (k + 1) - (first[k - 1][1] * k if k else 0.0)
        px = torch.as_tensor(self.pixels, device=self.film.accum.device)
        return dict(pool=self.run.scene.pool.detach().cpu().numpy(),
                    film=self.film.accum.reshape(-1, 3)[px].double().cpu(),
                    film_spp=self.film.spp, film_view=self.film_view, pass_rays=first[k][0],
                    pass_energy=energy,
                    repeat_mismatches=mismatches)

    def control(self, ref) -> dict:
        """The same outputs from the reference `ref` (its own dtype)."""
        import torch

        film = self._film(ref, self.start)
        rad, rays = self._pass(ref)
        pool = torch.cat([ref.v0, ref.e1, ref.e2], dim=1).double().cpu().numpy()
        return dict(pool=pool, film=film.double().cpu(), film_spp=self.spp, film_view=self.start,
                    pass_rays=rays, pass_energy=float(rad.double().sum()), repeat_mismatches=0)

    def _cam(self, view):
        from portbench.reference import render

        pos, target = self.views[view]
        return render.camera_frame(pos, target, self.run.width, self.run.height)

    def _film(self, ref, view, spp=None):
        import torch

        from portbench.reference import render

        spp = self.spp if spp is None else spp
        px = torch.as_tensor(self.pixels, device=ref.device)
        s = torch.arange(spp, device=ref.device)
        rad, _ = render.path_trace(ref, self._cam(view), px.repeat_interleave(spp),
                                   s.repeat(len(px)), self.depth)
        return rad.reshape(len(px), spp, 3).sum(dim=1)

    def _pass(self, ref):
        from portbench.reference import render

        return render.pass_image(ref, self._cam(self.start), self.pass_index, self.depth)

    def check(self, ans: dict, ref) -> dict:
        film = self._film(ref, ans["film_view"], ans["film_spp"]).double().cpu()
        rad, rays = self._pass(ref)
        return dict(
            geometry_gap=traffic.geometry_gap(ans["pool"], ref),
            image_gap=float((ans["film"] - film).abs().sum() / film.abs().sum()),
            rays_gap=traffic.gap(ans["pass_rays"], rays),
            energy_gap=traffic.gap(ans["pass_energy"], float(rad.double().sum())),
            repeat_mismatches=float(ans["repeat_mismatches"]),
        )
