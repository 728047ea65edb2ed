"""Inverse rendering in the PyTorch port (`diff/optimize.make_train_step`,
`torch.optim.Adam`) against the JAX package's (`make_train_step` with
`optax.adam`), and the albedo recovery of the JAX package's
tests/test_diff.py:123-153 on the port.

The three-step comparison runs both packages on the bilinear cube scene
carried from the JAX package's, at 16x10, depth 2, the same learning
rate, from the same perturbed albedo, against one target (the JAX
package's render at the true parameters, at the `spp_index` of every
step: common random numbers).  Its parameters are the albedo and the
light colour, whose gradients are far from zero wherever they are not
exactly zero: Adam's first step moves every parameter by the learning
rate times the sign of its gradient, so a gradient that is rounding
residue would move the two packages apart by twice the rate.  Losses
within 1e-4 relative, parameters within 1e-5 after each step.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cpu_ray_tracer_tpu.core import camera as jax_cam
from cpu_ray_tracer_tpu.diff import grad as jax_grad
from cpu_ray_tracer_tpu.diff import optimize as jax_optimize
from cpu_ray_tracer_tpu.render import pathtracer as jax_pt
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.diff import grad as grad_mod
from cpu_ray_tracer_tpu_torch.diff.optimize import make_train_step
from cpu_ray_tracer_tpu_torch.render import pathtracer, whitted
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from cpu_ray_tracer_tpu_torch.scene.convert import params_from_arrays, scene_from_arrays
from torch_parity import CUBE_XML, jax_compile, jax_reference_env, jax_scene_arrays

LR, DEPTH, SALT, STEPS = 0.05, 2, 3, 3
KEYS = ("albedo", "light_color")
PERTURBED = (0.2, 0.9, 0.4)  # the cube's albedo (material slot 2) to start from


def test_three_adam_steps_match_optax():
    jax_scene, _ = jax_compile(CUBE_XML, bilinear=True)
    scene = scene_from_arrays(*jax_scene_arrays(jax_scene))
    jcam = jax_cam.make_camera(16, 10)
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        target, _ = jax_pt.render_pass(jax_scene, jcam, jnp.uint32(SALT), depth_limit=DEPTH,
                                       differentiable=True)
        jparams = jax_grad.extract_params(jax_scene, keys=KEYS)
        jparams["albedo"] = jparams["albedo"].at[2].set(jnp.array(PERTURBED))
        opt = optax.adam(LR)
        state = opt.init(jparams)
        jstep = jax_optimize.make_train_step(jax_scene, jcam, target, opt, depth_limit=DEPTH)
        history = []
        for _ in range(STEPS):
            jparams, state, loss = jstep(jparams, state, jnp.uint32(SALT))
            history.append((float(loss), {k: np.asarray(v) for k, v in jparams.items()}))

    start = grad_mod.extract_params(scene, KEYS)
    start["albedo"][2] = torch.tensor(PERTURBED)
    step = make_train_step(scene, cam_mod.make_camera(16, 10), torch.tensor(np.asarray(target)),
                           start, LR, DEPTH, device="cpu")
    assert isinstance(step.optimizer, torch.optim.Adam)
    for i, (want_loss, want) in enumerate(history):
        loss = float(step(SALT))
        assert loss == pytest.approx(want_loss, rel=1e-4), i
        for k in KEYS:
            np.testing.assert_allclose(step.params[k].detach().numpy(), want[k], atol=1e-5,
                                       rtol=0, err_msg=f"step {i} {k}")
    assert history[-1][0] < history[0][0]
    carried = params_from_arrays(history[-1][1])
    assert carried.keys() == step.params.keys()


def test_make_train_step_recovers_albedo_with_common_random_numbers():
    """The path tracer's objective at the target's `spp_index` is zero at
    the true parameters; 40 steps recover the cube's albedo."""
    scene, _ = compile_scene(CUBE_XML, bilinear=True, device="cpu")
    cam = cam_mod.make_camera(16, 10)
    target, _ = pathtracer.render_pass(scene, cam, SALT, DEPTH, differentiable=True)
    start = grad_mod.extract_params(scene, ("albedo",))
    truth = start["albedo"][2].clone()
    start["albedo"][2] = torch.tensor(PERTURBED)
    step = make_train_step(scene, cam, target.detach(), start, LR, DEPTH, device="cpu")
    losses = [float(step(SALT)) for _ in range(40)]
    assert losses[-1] < losses[0] * 0.05
    np.testing.assert_allclose(step.params["albedo"][2].detach().numpy(), truth.numpy(),
                               atol=0.08)


def test_make_train_step_needs_its_device():
    scene, _ = compile_scene(CUBE_XML, device="cpu")
    cam = cam_mod.make_camera(8, 6)
    target = torch.zeros(6, 8, 3)
    params = grad_mod.extract_params(scene, ("albedo",))
    # the default is the card: no CUDA device raises, a CPU scene does not serve it
    with pytest.raises((RuntimeError, ValueError)):
        make_train_step(scene, cam, target, params, LR)
    with pytest.raises(ValueError):
        make_train_step(scene, cam, target, params, LR, device="meta")


def whitted_image(scene, cam):
    return whitted.render(scene, cam, DEPTH, differentiable=True)["image"]


def test_albedo_recovery():
    """Inverse rendering of tests/test_diff.py:123-153: perturb the cube's
    albedo and recover it from the original image by 60 Adam steps on the
    Whitted frame."""
    scene, _ = compile_scene(CUBE_XML, bilinear=True, device="cpu")
    cam = cam_mod.make_camera(16, 10)
    target = whitted_image(scene, cam).detach()
    true_albedo = grad_mod.extract_params(scene, ("albedo",))["albedo"]
    albedo = true_albedo.clone()
    albedo[2] = torch.tensor(PERTURBED)
    albedo.requires_grad_()
    loss_fn = grad_mod.make_loss_fn(scene, lambda s: whitted_image(s, cam), target)
    opt = torch.optim.Adam([albedo], lr=LR)
    losses = []
    for _ in range(60):
        opt.zero_grad()
        loss = loss_fn({"albedo": albedo})
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] * 0.05
    np.testing.assert_allclose(albedo[2].detach().numpy(), true_albedo[2].numpy(), atol=0.08)
