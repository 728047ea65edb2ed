"""Inverse rendering on one device, as the JAX package's
`cpu_ray_tracer_tpu/diff/optimize.py` `make_train_step`: recover scene
parameters from a target image by gradient descent with Adam.
`torch.optim.Adam` makes the update of `optax.adam` (bias-corrected
moments, eps outside the square root).  The sharded step waits for the
multi-device port (ROADMAP queue 1, item 14)."""

from __future__ import annotations

import torch

from cpu_ray_tracer_tpu_torch.core import device as device_mod
from cpu_ray_tracer_tpu_torch.core.camera import Camera
from cpu_ray_tracer_tpu_torch.diff import grad as grad_mod
from cpu_ray_tracer_tpu_torch.render import pathtracer


def make_train_step(scene, camera: Camera, target: torch.Tensor, params: dict, lr: float,
                    depth_limit: int = 3, device=device_mod.DEFAULT):
    """Train step over `params` (a dict of `diff/grad.PARAM_KEYS`): render
    a differentiable path-tracer pass, take the L2 loss against `target`
    [H, W, 3], and make one Adam step at learning rate `lr`.  The scene,
    the target and the step live on `device` (the card unless the caller
    asks for another; without a CUDA device the default raises).

    Returns `step(spp_index) -> loss` (the loss before the update); the
    parameters it updates in place are `step.params`, its optimizer
    `step.optimizer`.  Passing the target's `spp_index` on every step
    (common random numbers) makes the objective deterministic and zero at
    the target's parameters."""
    dev = device_mod.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if scene.device != dev or target.device != dev:
        raise ValueError(f"make_train_step on {dev}: the scene is on {scene.device}, the "
                         f"target on {target.device}")
    leaves = {k: v.detach().to(dev).clone().requires_grad_() for k, v in params.items()}
    optimizer = torch.optim.Adam(list(leaves.values()), lr=lr)

    def step(spp_index: int) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        img, _ = pathtracer.render_pass(grad_mod.apply_params(scene, leaves), camera, spp_index,
                                        depth_limit, differentiable=True)
        loss = grad_mod.l2_image_loss(img, target)
        loss.backward()
        for p in leaves.values():
            if p.grad is None:  # optax updates a parameter with a zero gradient too
                p.grad = torch.zeros_like(p)
        optimizer.step()
        return loss.detach()

    step.params, step.optimizer = leaves, optimizer
    return step
