"""One `render/whitted.render` frame of depth `depth` an iteration, the
camera stepping along the seeded orbit, `orbit_frames` frames a turn.

Parameters: `width`, `height`, `depth`, `orbit` (`lib/scenario.py`),
`orbit_frames`, `check_first_frames` (the check compares a frame drawn
among these, and the last), `trace_units` (frames in a traced window)."""

from __future__ import annotations

import math
import time

from portbench.lib import scenario, traffic

FAULTS = ("unchanged", "half", "answer")


def plant(fault: str, patch):
    """`unchanged`: a frame's later levels left out (the first level's
    radiance returned); `half`: every other pixel left out, the rest
    doubled; `answer`: a frame's radiance times 1.01."""
    import torch

    from cpu_ray_tracer_tpu_torch.render import whitted

    radiance = whitted.radiance

    def altered(scene, o, d, depth_limit=5, *args, **kwargs):
        if fault == "unchanged":
            return radiance(scene, o, d, 0, *args, **kwargs)
        film, stats = radiance(scene, o, d, depth_limit, *args, **kwargs)
        if fault == "half":
            keep = torch.arange(film.shape[0], device=film.device) % 2 == 1
            film = torch.where(keep[:, None], 2 * film, torch.zeros_like(film))
        return (film if fault == "half" else film * 1.01), stats

    patch(whitted, "radiance", altered)


class Loop(traffic.Entry):
    def __init__(self, run):
        from cpu_ray_tracer_tpu_torch.core.camera import make_camera

        super().__init__(run)
        p = self.params
        self.depth = p["depth"]
        phase0 = run.inputs.uniform(0, 2 * math.pi)
        turn = p["orbit_frames"]
        self.views = [scenario.orbit(phase0 + 2 * math.pi * k / turn, **p["orbit"])
                      for k in range(turn)]
        self.cameras = [make_camera(run.width, run.height, pos=a, target=b) for a, b in self.views]
        self.sample = int(run.draws.integers(p["check_first_frames"]))
        self.frames, self.kept = 0, {}

    def unit(self) -> list:
        from cpu_ray_tracer_tpu_torch.render import whitted

        k = self.frames % len(self.cameras)
        out = whitted.render(self.run.scene, self.cameras[k], depth_limit=self.depth)
        traffic.sync(self.run.device)
        t = time.perf_counter()
        frame = (k, out["image"].reshape(-1, 3), out["rays"])
        self.kept = {key: v for key, v in self.kept.items() if key == self.sample}
        self.kept[self.frames] = frame
        self.frames += 1
        # a frame ends its levels where no child is left: it reports how many it traced
        return [(t, out["rays"], out["levels"])]

    def warm_up(self):
        for _ in range(2):
            self.unit()

    def release(self):
        self.run.scene, self.kept = None, {}

    def answers(self) -> dict:
        """The drawn frame (the last, where the run made fewer) and the
        last frame: their views, images and rays."""
        keep = sorted({min(self.sample, self.frames - 1), self.frames - 1})
        frames = [(self.kept[i][0], self.kept[i][1].double().cpu(), self.kept[i][2]) for i in keep]
        return dict(pool=self.run.scene.pool.detach().cpu().numpy(), frames=frames)

    def control_views(self) -> list:
        """The views the control renders: the drawn frame's and the next."""
        return [(self.sample + i) % len(self.views) for i in (0, 1)]

    def _cam(self, k):
        from portbench.reference import render

        pos, target = self.views[k]
        return render.camera_frame(pos, target, self.run.width, self.run.height)

    def control(self, ref) -> dict:
        import torch

        from portbench.reference import render

        frames = []
        for k in self.control_views():
            img, rays = render.whitted(ref, self._cam(k), self.depth)
            frames.append((k, img.double().cpu(), rays))
        pool = torch.cat([ref.v0, ref.e1, ref.e2], dim=1).double().cpu().numpy()
        return dict(pool=pool, frames=frames)

    def check(self, ans: dict, ref) -> dict:
        from portbench.reference import render

        image_gap = rays_gap = 0.0
        for k, img, rays in ans["frames"]:
            want, want_rays = render.whitted(ref, self._cam(k), self.depth)
            want = want.double().cpu()
            image_gap = max(image_gap, float((img - want).abs().sum() / want.abs().sum()))
            rays_gap = max(rays_gap, traffic.gap(rays, want_rays))
        return dict(geometry_gap=traffic.geometry_gap(ans["pool"], ref), image_gap=image_gap,
                    rays_gap=rays_gap)

