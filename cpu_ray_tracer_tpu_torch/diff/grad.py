"""Differentiable-rendering parameters, as the JAX package's
`cpu_ray_tracer_tpu/diff/grad.py`.

The parameters are the scene quantities the system's north star names:
material albedo, reflectivity, refractivity and absorption, the texels of
the float atlas, the light colour and the triangle vertices (`v0`, `e1`,
`e2` of the triangle pool).  `apply_params` swaps a parameter dict into a
copy of a `DeviceScene`; the integrators called with `differentiable=True`
then give image gradients to all of them (detached visibility:
`scene/query.find_nearest_diff`).  Texel gradients need a bilinear scene:
the nearest tap reads the packed atlas, which no parameter feeds.
"""

from __future__ import annotations

import copy

import torch

from cpu_ray_tracer_tpu_torch.ops import surface

PARAM_KEYS = (
    "albedo",
    "reflectivity",
    "refractivity",
    "absorption",
    "texels",
    "light_color",
    "v0",
    "e1",
    "e2",
)
# the scene buffer each key replaces; v0, e1, e2 are columns of `pool`
_BUFFERS = dict(albedo="mat_albedo", reflectivity="mat_reflectivity",
                refractivity="mat_refractivity", absorption="mat_absorption",
                texels="atlas_texels", light_color="light_color")
_POOL = ("v0", "e1", "e2")


def _source(scene, key: str) -> torch.Tensor:
    if key in _POOL:
        i = _POOL.index(key)
        return scene.pool[:, 3 * i:3 * i + 3]
    return getattr(scene, _BUFFERS[key])


def extract_params(scene, keys=("albedo", "texels", "light_color")) -> dict:
    """The scene's current values of `keys`: detached contiguous copies."""
    return {k: _source(scene, k).detach().clone(memory_format=torch.contiguous_format)
            for k in keys}


def apply_params(scene, params: dict):
    """A new DeviceScene that shares every buffer of `scene` but those the
    parameters replace: the material and texel tables and the light colour
    by the tensors of `params`, `pool` re-joined from `v0 | e1 | e2`.  The
    wavefront and Whitted kernels' `kernel_params` is packed anew from the
    new materials, detached.  The walk records stay as built (no refit)."""
    for k, v in params.items():
        if k not in PARAM_KEYS:
            raise KeyError(f"{k!r} is not a parameter ({', '.join(PARAM_KEYS)})")
        if v.shape != _source(scene, k).shape:
            raise ValueError(f"{k}: shape {tuple(v.shape)}, the scene's "
                             f"{tuple(_source(scene, k).shape)}")
    out = copy.copy(scene)
    out._buffers = dict(scene._buffers)
    for k, name in _BUFFERS.items():
        if k in params:
            out._buffers[name] = params[k]
    if any(k in params for k in _POOL):
        out._buffers["pool"] = torch.cat(
            [params[k] if k in params else _source(scene, k) for k in _POOL], dim=1)
    if "kernel_params" in scene._buffers:  # a PrimScene runs no fused kernel
        with torch.no_grad():
            out._buffers["kernel_params"] = surface.kernel_params(out)
    return out


def l2_image_loss(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((img - target) ** 2).mean()


def make_loss_fn(scene, render_fn, target: torch.Tensor):
    """`render_fn(scene) -> image`.  Returns loss(params)."""

    def loss(params):
        return l2_image_loss(render_fn(apply_params(scene, params)), target)

    return loss


def value_and_grad(loss_fn, params: dict):
    """(loss, gradients) of `loss_fn` at `params`, as `jax.value_and_grad`:
    the loss detached, and a gradient for every key, zeros where the loss
    does not depend on it."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), grads)}


def finite_difference(loss_fn, params: dict, key: str, index: int, eps: float = 1e-3):
    """Central finite difference of the loss with respect to one scalar
    entry (flat `index`) of `params[key]`: the gradients' oracle."""

    def perturbed(sign):
        p = dict(params)
        flat = p[key].detach().reshape(-1).clone()
        flat[index] += sign * eps
        p[key] = flat.reshape(p[key].shape)
        return loss_fn(p)

    with torch.no_grad():
        return (perturbed(+1.0) - perturbed(-1.0)) / (2 * eps)
