"""Inverse rendering, as the JAX package's
`cpu_ray_tracer_tpu/diff/optimize.py`: recover scene parameters from a
target image by gradient descent with Adam, on one device
(`make_train_step`) or with the pixels split over the ranks of a ray mesh
(`make_sharded_train_step`, `parallel/mesh.py`).  `torch.optim.Adam`
makes the update of `optax.adam` (bias-corrected moments, eps outside the
square root)."""

from __future__ import annotations

import torch

from cpu_ray_tracer_tpu_torch.core import device as device_mod
from cpu_ray_tracer_tpu_torch.core.camera import Camera
from cpu_ray_tracer_tpu_torch.diff import grad as grad_mod
from cpu_ray_tracer_tpu_torch.parallel import sharded
from cpu_ray_tracer_tpu_torch.parallel.mesh import Mesh
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
    dev = _check_devices("make_train_step", device_mod.resolve(device), scene, target)
    leaves, optimizer = _adam(params, lr, dev)

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


def _check_devices(what: str, dev: torch.device, scene, target: torch.Tensor) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if scene.device != dev or target.device != dev:
        raise ValueError(f"{what} on {dev}: the scene is on {scene.device}, the target on "
                         f"{target.device}")
    return dev


def _adam(params: dict, lr: float, dev: torch.device):
    leaves = {k: v.detach().to(dev).clone().requires_grad_() for k, v in params.items()}
    return leaves, torch.optim.Adam(list(leaves.values()), lr=lr)


def make_sharded_train_step(scene, camera: Camera, target: torch.Tensor, params: dict,
                            lr: float, mesh: Mesh, depth_limit: int = 3):
    """The train step of `make_train_step` with the pixels split over the
    ranks of `mesh` (the JAX package's `make_sharded_train_step`,
    diff/optimize.py:49-121): every rank holds the scene, the target and
    the parameters on its device, renders its block of pixels
    (`parallel/sharded.py`), takes the loss sum((radiance - target)^2) /
    (n 3) over its n/world pixels of the frame's n, and all-reduces the
    loss and every gradient (a parameter without one gets zeros) before
    one Adam step, so the ranks stay equal and the loss is the frame's L2
    loss.  The pixel count must divide by the world size.

    `target` is one image [H, W, 3] or a stack [K, H, W, 3] for training on
    common random numbers: step `spp_index` then compares with target
    `spp_index % K` and draws the per-pixel streams of sample index
    `spp_index % K`, those the target's render at that index drew.

    Returns `step(spp_index) -> loss` (the frame's loss before the
    update), with `step.params` and `step.optimizer` as
    `make_train_step`'s."""
    dev = _check_devices("make_sharded_train_step", mesh.device, scene, target)
    n = camera.width * camera.height
    start, end = mesh.block(n)
    crn = target.dim() == 4
    n_targets = target.shape[0] if crn else 1
    target_block = target.reshape(n_targets, n, 3)[:, start:end]
    leaves, optimizer = _adam(params, lr, dev)

    def step(spp_index: int) -> torch.Tensor:
        index = spp_index % n_targets if crn else spp_index
        optimizer.zero_grad(set_to_none=True)
        o, d, seeds = sharded.block_rays(camera, index, start, end, dev)
        radiance, _ = pathtracer.sample_radiance(grad_mod.apply_params(scene, leaves), o, d,
                                                 seeds, depth_limit, differentiable=True)
        loss = ((radiance - target_block[index if crn else 0]) ** 2).sum() / (n * 3)
        loss.backward()
        for p in leaves.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        sharded.psum_grads({k: p.grad for k, p in leaves.items()}, mesh)
        loss = loss.detach()
        torch.distributed.all_reduce(loss)
        optimizer.step()
        return loss

    step.params, step.optimizer = leaves, optimizer
    return step
