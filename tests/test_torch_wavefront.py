"""The wavefront path tracer of the PyTorch port against the JAX package.

`trace_plain` (the CUDA kernel's plain PyTorch version) against the JAX
package's wavefront kernel `wavefront_pt.trace` in interpret mode, on the
same tables (`scene_from_arrays`) and the same camera rays; and
`render_pass(wavefront_depths=k)` against the JAX package's `render_pass`
with `CRT_WAVEFRONT=1`, `CRT_WF_DEPTHS=k`.

Per ray: flags, texel indices, locus (mapped from the port's unpadded slots
to the JAX packing's padded ones) and live counts exact; tp, o and d at the
parity tolerance (atol=2e-5, rtol=1e-4).  Seeds are exact on the rays
still alive after the last depth: the TPU kernel draws for every lane of a
tile that has a live lane, so a dead ray's seed there depends on its tile;
the port's dead rays draw nothing.  The JAX counters are tile walks and are
not compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu.core import camera as jax_cam
from cpu_ray_tracer_tpu.ops.pallas import wavefront_pt as jax_wf
from cpu_ray_tracer_tpu.render import pathtracer as jax_pt
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.ops import wavefront_pt
from cpu_ray_tracer_tpu_torch.render import borderline, pathtracer
from cpu_ray_tracer_tpu_torch.scene.convert import scene_from_arrays
from torch_parity import (
    BENCH_CAMERA, BENCH_XML, CUBE_XML, jax_compile, jax_reference_env, jax_scene_arrays,
)

DEPTH = 5
CASES = {
    # (xml, width, height, camera)
    "bunny_teapot": (BENCH_XML, 64, 40, BENCH_CAMERA),
    "cube_scene": (CUBE_XML, 48, 32, {}),  # a one-leaf tree
}
FLAGS = ("missed", "lit", "alive", "inside")


@pytest.fixture(scope="module", params=list(CASES))
def scenes(request):
    jax_scene, _ = jax_compile(CASES[request.param][0])
    arrays, meta = jax_scene_arrays(jax_scene)
    shade = arrays["packed.tri_shade_rows"].reshape(-1, 16).view(np.int32)
    # the JAX slot of each of the port's slots (its packing pads every row)
    jax_slot = np.nonzero(shade[:, 15] != 0)[0]
    return request.param, jax_scene, scene_from_arrays(arrays, meta), jax_slot


def _rays(name):
    _, w, h, cam = CASES[name]
    return pathtracer.camera_rays(cam_mod.make_camera(w, h, **cam), 1)


def _masks(n):
    rng = np.random.default_rng(3)
    alive = rng.uniform(size=n) < 0.8
    inside = alive & (rng.uniform(size=n) < 0.3)
    return alive, inside


def _compare(got, want, jax_slot, entered):
    """Port outputs (torch) against JAX outputs (numpy) on the rays
    `entered` (alive on entry)."""
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["live_counts"], want["live_counts"])
    for key in FLAGS:
        np.testing.assert_array_equal(got[key][entered], want[key][entered], err_msg=key)
    np.testing.assert_array_equal(got["tex_idx"][entered], want["tex_idx"][entered])
    locus = np.where(got["locus"] >= 0, jax_slot[np.maximum(got["locus"], 0)], -1)
    np.testing.assert_array_equal(locus[entered], want["locus"][entered])
    for key in ("tp", "o", "d"):
        np.testing.assert_allclose(got[key][entered], want[key][entered], atol=2e-5, rtol=1e-4,
                                   err_msg=key)
    alive = got["alive"]
    np.testing.assert_array_equal(got["seed"][alive], want["seed"][alive].astype(np.int64))
    return got


@pytest.mark.parametrize("k", [1, 6])
def test_trace_plain_matches_jax_kernel(scenes, k):
    name, jax_scene, port, jax_slot = scenes
    o, d, seeds = _rays(name)
    want = jax_wf.trace(
        jax_scene, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(seeds.numpy().astype(np.uint32)), k, DEPTH, interpret=True,
    )
    want = {key: np.asarray(v) for key, v in want.items()}
    got = wavefront_pt.trace(port, o, d, seeds, k, DEPTH)
    entered = np.ones(o.shape[0], bool)
    got = _compare(got, want, jax_slot, entered)
    assert got["live_counts"][0] == o.shape[0]
    if k == 1:
        # every ray drew exactly four numbers in both
        np.testing.assert_array_equal(got["seed"], want["seed"].astype(np.int64))
        assert got["tex_idx"].shape == (o.shape[0], 1)
    assert (got["traversed"] >= 0).all() and got["tested"].sum() > 0
    # dead lanes of the last depth left the kernel unchanged from their end
    assert not (got["alive"] & (got["missed"] | got["lit"])).any()


@pytest.mark.parametrize("depth_base", [0, DEPTH])
def test_trace_plain_with_masks_matches_jax_kernel(scenes, depth_base):
    """`alive` / `inside` carried in (the Beer term and the inverted
    index of refraction); at depth_base = depth_limit the first depth is
    the cutoff: every live ray records its miss and dies."""
    name, jax_scene, port, jax_slot = scenes
    o, d, seeds = _rays(name)
    alive, inside = _masks(o.shape[0])
    want = jax_wf.trace(
        jax_scene, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(seeds.numpy().astype(np.uint32)), 2, DEPTH, interpret=True,
        alive=jnp.asarray(alive), inside=jnp.asarray(inside), depth_base=depth_base,
    )
    want = {key: np.asarray(v) for key, v in want.items()}
    got = wavefront_pt.trace(
        port, o, d, seeds, 2, DEPTH, torch.from_numpy(alive), torch.from_numpy(inside), depth_base,
    )
    got = _compare(got, want, jax_slot, alive)
    # rays dead on entry pass through unchanged
    dead = ~alive
    np.testing.assert_array_equal(got["o"][dead], o.numpy()[dead])
    np.testing.assert_array_equal(got["seed"][dead], seeds.numpy()[dead])
    np.testing.assert_array_equal(got["inside"][dead], inside[dead])
    assert (got["tp"][dead] == 1).all() and (got["tex_idx"][dead] == -1).all()
    if depth_base == DEPTH:
        assert not got["alive"].any() and not got["lit"].any()
        assert got["live_counts"].tolist() == [int(alive.sum()), 0]
        assert (got["tp"] == 1).all()
    else:
        assert got["alive"].any()


@pytest.fixture(scope="module", params=[1, 6])
def jax_render(request):
    """The JAX wavefront render of bunny_teapot 64x40 and its ray count."""
    xml, w, h, cam = CASES["bunny_teapot"]
    jax_scene, _ = jax_compile(xml)
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        mp.setenv("CRT_WAVEFRONT", "1")
        mp.setenv("CRT_WF_DEPTHS", str(request.param))
        img, stats = jax_pt.render_pass(jax_scene, jax_cam.make_camera(w, h, **cam), jnp.uint32(1))
        img, rays = np.asarray(img), int(stats["rays_traced"])
    return request.param, img, rays, jax_scene_arrays(jax_scene)


def _unexplained(scene, camera, k, img, ref):
    return borderline.unexplained_pixels(
        lambda o, d, s: pathtracer.sample_radiance(scene, o, d, s, DEPTH, k)[0],
        pathtracer.camera_rays(camera, 1), img, ref,
    )["unexplained"]


def test_render_pass_matches_jax_wavefront(jax_render):
    k, ref, rays, (arrays, meta) = jax_render
    scene = scene_from_arrays(arrays, meta)
    xml, w, h, cam = CASES["bunny_teapot"]
    camera = cam_mod.make_camera(w, h, **cam)
    img, stats = pathtracer.render_pass(scene, camera, 1, DEPTH, wavefront_depths=k)
    assert stats["rays_traced"] == rays == 4553
    assert bool(torch.isfinite(img).all()) and float(img.sum()) > 0
    bad = _unexplained(scene, camera, k, img, torch.from_numpy(ref.copy()))
    assert bad.numel() == 0, f"pixels {bad.tolist()} differ and are not fp-borderline"


@pytest.mark.parametrize("k", [1, 6])
def test_wavefront_matches_host_bounce(scenes, k):
    """The port's k > 0 against its own host bounce (k = 0): the same
    estimator, so the same ray count, and the image at the parity
    tolerance except fp-borderline pixels."""
    name, _, port, _ = scenes
    xml, w, h, cam = CASES[name]
    camera = cam_mod.make_camera(w, h, **cam)
    ref, st0 = pathtracer.render_pass(port, camera, 1, DEPTH, wavefront_depths=0)
    img, st = pathtracer.render_pass(port, camera, 1, DEPTH, wavefront_depths=k)
    assert st["rays_traced"] == st0["rays_traced"]
    assert _unexplained(port, camera, k, img, ref).numel() == 0
