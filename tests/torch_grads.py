"""Shared helpers of the gradient tests (`test_torch_diff*.py`,
`test_torch_optimize.py`): the same loss through the JAX package's
`jax.vjp` and the port's autograd, and the gradients' tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu.core import textures as jax_tex
from cpu_ray_tracer_tpu.diff import grad as jax_grad
from cpu_ray_tracer_tpu_torch.diff import grad as grad_mod
from cpu_ray_tracer_tpu_torch.render import borderline
from cpu_ray_tracer_tpu_torch.scene.convert import params_from_arrays
from torch_taps import Taps

ATOL, RTOL = 2e-5, 1e-4  # image parity
# gradients: atol relative to the largest |g|, for entries that are last-
# bit residue in both packages: a texel's bilinear weight (1 - tx) near 0
# takes the sky's atan2 / acos rounding times the texture width (up to 6e-5
# of max|g|), and the diffuse weight's cosine, analytically constant in the
# normal (the shading frame is orthonormal), leaves a rounding-level vertex
# gradient (up to 1.4e-4 of max|g| on bunny_teapot)
G_ATOL, G_RTOL = 2e-4, 1e-3
KEYS = grad_mod.PARAM_KEYS
DEPTH = 2


def assert_grad_close(got, want, name):
    want = np.asarray(want)
    got = np.asarray(got)
    scale = float(np.abs(want).max())
    err = np.abs(got - want)
    worst = np.unravel_index(np.argmax(err - G_RTOL * np.abs(want)), err.shape)
    np.testing.assert_allclose(
        got, want, atol=G_ATOL * scale, rtol=G_RTOL,
        err_msg=f"{name}: max|g| {scale:.6g}, worst at {worst}: {got[worst]} vs {want[worst]}")


def jax_taps(jax_render, jax_scene) -> tuple:
    """(image, `torch_taps.Taps`) of a forward `jax_render(jax_scene)`
    with the JAX package's bilinear taps recorded."""
    taps = Taps()
    tap = jax_tex.sample_bilinear

    def recording(atlas, tex_id, u, v):
        tid = np.maximum(np.asarray(tex_id), 0)
        taps.add(u, v, np.asarray(atlas.width)[tid], np.asarray(atlas.height)[tid])
        return tap(atlas, tex_id, u, v)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_tex, "sample_bilinear", recording)
        return np.asarray(jax_render(jax_scene)), taps


def masked_grads(jax_render, render, jax_scene, scene, rays, replay_stats=None):
    """The image of `render(scene)` and of `jax_render(jax_scene)` and the
    gradients of the L2 loss against a black target over the pixels where
    both images agree, for every key of PARAM_KEYS: (port grads, JAX
    grads, pixels left out).  `rays` = (o, d, seeds or None) of the frame,
    for the borderline probe.  With a dict `replay_stats` the port's
    renders replay the JAX package's bilinear tap positions
    (`torch_taps`), and the dict gets the replay's counts."""
    jparams = jax_grad.extract_params(jax_scene, keys=KEYS)
    img_j, vjp = jax.vjp(lambda p: jax_render(jax_grad.apply_params(jax_scene, p)), jparams)
    img_j = np.asarray(img_j)
    params = params_from_arrays({k: np.asarray(v) for k, v in jparams.items()})
    if replay_stats is not None:
        img_rec, taps = jax_taps(jax_render, jax_scene)
        np.testing.assert_array_equal(img_rec, img_j)  # the taps of the vjp's forward
        full_render = render

        def render(sc, *rays_):
            if rays_:  # the borderline probe's rays: not the frame's taps
                return full_render(sc, *rays_)
            with pytest.MonkeyPatch.context() as mp:
                taps.replay_port(mp, replay_stats)
                out = full_render(sc)
            assert replay_stats["calls"] == len(taps.calls), replay_stats
            return out
    with torch.no_grad():
        img = render(scene)
    mask, cmp = borderline.agreement_mask(
        lambda o, d, s: render(scene, o, d, s), rays, img, torch.tensor(img_j), ATOL, RTOL)
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()
    # the cotangent of mean(mask * img^2) against a black target
    (g_j,) = vjp(jnp.asarray(2.0 * mask.numpy() * img_j / img_j.size, jnp.float32))
    loss_fn = grad_mod.make_loss_fn(scene, lambda s: render(s) * mask,
                                    torch.zeros(img.shape))
    _, g = grad_mod.value_and_grad(loss_fn, params)
    return g, g_j, cmp["bad"]
