"""One step of `diff/optimize.make_train_step` an iteration, over every key
of `diff/grad.PARAM_KEYS`, against a target rendered in set-up from
perturbed parameters (albedo x0.8, light colour x0.9) at a seeded
`spp_index`, which every step passes.  Set-up drives the first three
steps through the window's own call; the check follows them.

Parameters: `width`, `height`, `depth` (the step's depth limit), `lr`,
`orbit` (`lib/scenario.py`), `swing_leaves` (the leaves the check holds
by their median, `Loop.check`), `trace_units` (steps in a traced
window)."""

from __future__ import annotations

import math
import time

import numpy as np

from portbench.lib import scenario, traffic

BETAS = (0.9, 0.999)  # the optimizer's (torch.optim.Adam's defaults)
ADAM_EPS = 1e-8
FAULTS = ("unchanged", "half", "answer", "ascent")


def plant(fault: str, patch):
    """`unchanged`: the optimizer's step does nothing; `half`: the loss over
    every other column; `answer`: the loss times 1.01; `ascent`: every
    gradient's sign flipped where the optimizer gets it."""
    import torch

    from cpu_ray_tracer_tpu_torch.diff import grad as grad_mod

    if fault == "unchanged":
        patch(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif fault == "ascent":
        step = torch.optim.Adam.step

        def ascent(self, closure=None):
            with torch.no_grad():
                for group in self.param_groups:
                    for p in group["params"]:
                        if p.grad is not None:
                            p.grad.neg_()
            return step(self, closure)

        patch(torch.optim.Adam, "step", ascent)
    else:
        loss_fn = grad_mod.l2_image_loss

        def altered(img, target):
            if fault == "half":
                return ((img - target)[:, 1::2] ** 2).mean()
            return loss_fn(img, target) * 1.01

        patch(grad_mod, "l2_image_loss", altered)


def leaf_readings(got: dict, want: dict, moved: list) -> dict:
    """For each leaf of `moved`: the program's and the reference's norms, the
    gap of the norms over the larger of the reference's norm of the leaf
    and of the median moved leaf, and the turn, 1 - cos of the angle
    between the two (1 where either is zero)."""
    norm = {k: (float(got[k].norm()), float(want[k].norm())) for k in moved}
    med = float(np.median([r for _, r in norm.values()]))
    out = {}
    for k in moved:
        a, b = norm[k]
        dot = float((got[k].reshape(-1) * want[k].reshape(-1)).sum())
        out[k] = dict(norm=a, ref_norm=b, gap=abs(a - b) / max(b, med, 1e-300),
                      turn=1.0 - (dot / (a * b) if a > 0 and b > 0 else 0.0))
    return out


class Loop(traffic.Entry):
    FIRST_STEPS = 3

    def __init__(self, run):
        import torch

        from cpu_ray_tracer_tpu_torch.core.camera import make_camera
        from cpu_ray_tracer_tpu_torch.diff import grad, optimize
        from cpu_ray_tracer_tpu_torch.render import pathtracer

        super().__init__(run)
        p = self.params
        self.pos, self.target = scenario.orbit(run.inputs.uniform(0, 2 * math.pi), **p["orbit"])
        self.spp_index = int(run.inputs.integers(1 << 16))
        self.depth, self.lr = p["depth"], p["lr"]
        self.camera = make_camera(run.width, run.height, pos=self.pos, target=self.target)
        scene = run.scene
        self.params0 = grad.extract_params(scene, grad.PARAM_KEYS)
        t = time.perf_counter()
        with torch.no_grad():
            target, _ = pathtracer.render_pass(
                grad.apply_params(scene, self._perturbed(self.params0)), self.camera,
                self.spp_index, self.depth, differentiable=True)
        traffic.sync(run.device)
        self.target_s = time.perf_counter() - t
        self.step = optimize.make_train_step(scene, self.camera, target, self.params0, self.lr,
                                             self.depth, device=run.device)
        self.losses, self.grads, self.changes = [], {}, {}

    @staticmethod
    def _perturbed(params: dict) -> dict:
        return dict(params, albedo=params["albedo"] * 0.8,
                    light_color=params["light_color"] * 0.9)

    def unit(self) -> list:
        loss = self.step(self.spp_index)
        traffic.sync(self.run.device)
        t = time.perf_counter()
        if len(self.losses) < self.FIRST_STEPS:
            self._record(float(loss))
        # the forward walks depths 0 to the limit; the backward walks none
        return [(t, 0, self.depth + 1)]

    def _record(self, loss: float):
        import torch

        self.losses.append(loss)
        state = self.step.optimizer.state
        if len(self.losses) == 1:  # the first gradient, as the optimizer got it
            # (a step that applied no update left no state: no gradient reached it)
            self.grads = {k: state[p]["exp_avg"] / (1 - BETAS[0]) if "exp_avg" in state[p]
                          else torch.zeros_like(p) for k, p in self.step.params.items()}
        if len(self.losses) == self.FIRST_STEPS:
            self.changes = {k: p.detach() - self.params0[k] for k, p in self.step.params.items()}
            self.params0 = None

    def warm_up(self):
        steps = []
        for _ in range(self.FIRST_STEPS):
            t = time.perf_counter()
            self.unit()
            steps.append(time.perf_counter() - t)
        self.warm_split = dict(target_s=self.target_s, first_steps_s=steps)

    def values(self, times_ms: np.ndarray, rays: int, window: float) -> dict:
        return dict(grad_step_ms=1e3 * window / len(times_ms),
                    iter_ms_p95=float(np.percentile(times_ms, 95)))

    def traced_rays(self, records: list) -> int:
        """Path segments of one step's forward at the current parameters,
        times the steps (one more forward, outside the traced window)."""
        import torch

        from cpu_ray_tracer_tpu_torch.diff import grad
        from cpu_ray_tracer_tpu_torch.render import pathtracer

        with torch.no_grad():
            _, stats = pathtracer.render_pass(grad.apply_params(self.run.scene, self.step.params),
                                              self.camera, self.spp_index, self.depth,
                                              differentiable=True)
        return int(stats["rays_traced"]) * len(records)

    def release(self):
        self.run.scene, self.step = None, None

    def answers(self) -> dict:
        return dict(losses=list(self.losses),
                    grads={k: v.double().cpu() for k, v in self.grads.items()},
                    changes={k: v.double().cpu() for k, v in self.changes.items()})

    def _train(self, ref) -> dict:
        """The reference's first steps: the target at the perturbed
        parameters, then the loss, its gradients and Adam's update at each
        step (hits in the scene as built, t, u, v in the current
        parameters, as the program's detached visibility does)."""
        import torch

        from portbench.reference import render

        cam = render.camera_frame(self.pos, self.target, self.run.width, self.run.height)
        p0 = {k: v.detach().clone() for k, v in ref.params().items()}
        with torch.no_grad():
            target, _ = render.pass_image(ref.with_params(self._perturbed(p0)), cam,
                                          self.spp_index, self.depth)
        params = {k: v.clone() for k, v in p0.items()}
        m = {k: torch.zeros_like(v) for k, v in params.items()}
        v2 = {k: torch.zeros_like(v) for k, v in params.items()}
        out = dict(losses=[], grads={}, changes={})
        for step in range(1, self.FIRST_STEPS + 1):
            leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
            img, _ = render.pass_image(ref.with_params(leaves), cam, self.spp_index, self.depth,
                                       hit_scene=ref)
            loss = ((img - target) ** 2).mean()
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            out["losses"].append(float(loss.detach()))
            with torch.no_grad():
                for (k, p), g in zip(leaves.items(), grads):
                    g = torch.zeros_like(p) if g is None else g
                    if step == 1:
                        out["grads"][k] = g.double().cpu()
                    m[k] = BETAS[0] * m[k] + (1 - BETAS[0]) * g
                    v2[k] = BETAS[1] * v2[k] + (1 - BETAS[1]) * g * g
                    denom = (v2[k] / (1 - BETAS[1] ** step)).sqrt() + ADAM_EPS
                    params[k] = p.detach() - self.lr / (1 - BETAS[0] ** step) * m[k] / denom
        out["changes"] = {k: (params[k] - p0[k]).double().cpu() for k in params}
        return out

    def control(self, ref) -> dict:
        return self._train(ref)

    def check(self, ans: dict, ref) -> dict:
        """The first step's loss; the first gradient and the parameters'
        change over the first steps, leaf by leaf (`leaf_readings`), over
        the leaves the reference moves: those whose reference gradient is a
        thousandth of the median leaf's or more (the others move under
        Adam by round-off alone).

        The first gradient's norm gap and turn (which sees a gradient of
        the wrong sign) are held by the worst leaf outside `swing_leaves`,
        and by their median inside: there a path that rounds to another
        hit in float32 than in float64 carries one vertex's gradient to
        another (PERF.md).  The change
        is held by the median leaf's norm gap: Adam moves every entry by
        about the learning rate whatever its gradient, so an entry whose
        gradient is round-off moves either way.  `self.leaves` keeps every
        leaf's readings for `calibrate.py`."""
        import torch

        want = self._train(ref)
        g_ref = {k: float(v.norm()) for k, v in want["grads"].items()}
        med_g = float(np.median(list(g_ref.values())))
        moved = sorted(k for k, g in g_ref.items() if g >= 1e-3 * med_g)
        got_g = {k: ans["grads"].get(k, torch.zeros_like(want["grads"][k])) for k in moved}
        got_c = {k: ans["changes"].get(k, torch.zeros_like(want["changes"][k])) for k in moved}
        grad = leaf_readings(got_g, want["grads"], moved)
        change = leaf_readings(got_c, want["changes"], moved)
        self.leaves = dict(grad=grad, change=change)
        swing = [k for k in moved if k in self.params["swing_leaves"]]
        fixed = [k for k in moved if k not in swing]
        return dict(
            first_loss_gap=traffic.gap(ans["losses"][0], want["losses"][0]),
            grad_gap_worst=max(grad[k]["gap"] for k in fixed),
            grad_gap_swing=float(np.median([grad[k]["gap"] for k in swing])),
            grad_turn_worst=max(grad[k]["turn"] for k in fixed),
            grad_turn_swing=float(np.median([grad[k]["turn"] for k in swing])),
            change_gap_median=float(np.median([change[k]["gap"] for k in moved])),
        )

