"""Per-ray RNG and camera rays of the PyTorch port against the JAX package:
the seed streams must be bit-equal (exact `rays_traced` parity rests on
them), primary rays allclose at 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu.core import camera as jax_cam
from cpu_ray_tracer_tpu.core import rng as jax_rng
from cpu_ray_tracer_tpu_torch.core import camera, rng
from cpu_ray_tracer_tpu_torch.render import pathtracer

N = 100_000


def _u32(seed):
    g = np.random.default_rng(seed)
    x = g.integers(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    x[:6] = [0, 1, 61, 2**31 - 1, 2**31, 2**32 - 1]  # edges of the uint32 range
    return x


def test_wang_hash_and_xorshift_bit_equal():
    x = _u32(11)
    t = torch.from_numpy(x.astype(np.int64))
    np.testing.assert_array_equal(
        rng.wang_hash(t).numpy(), np.asarray(jax_rng.wang_hash(jnp.asarray(x))).astype(np.int64)
    )
    np.testing.assert_array_equal(
        rng.xorshift32(t).numpy(), np.asarray(jax_rng.xorshift32(jnp.asarray(x))).astype(np.int64)
    )


@pytest.mark.parametrize("spp", [0, 1, 63, 2**22 + 7])
def test_pixel_seed_streams_bit_equal(spp):
    """pixel_seeds, then eight random_float draws: states and floats
    bit-equal over 10^5 pixels."""
    ids = np.arange(N, dtype=np.uint32) * np.uint32(7) + np.uint32(3)
    js = jax_rng.pixel_seeds(jnp.asarray(ids), jnp.uint32(spp))
    ts = rng.pixel_seeds(torch.from_numpy(ids.astype(np.int64)), spp)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    for _ in range(8):
        js, jf = jax_rng.random_float(js)
        ts, tf = rng.random_float(ts)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
        assert tf.dtype == torch.float32
        np.testing.assert_array_equal(tf.numpy().view(np.int32), np.asarray(jf).view(np.int32))


def test_random_float_rounds_to_nearest():
    """uint32 -> float32 rounds to nearest: the values just below 2^32 map
    to 1.0 after scaling, as the JAX conversion does."""
    x = np.array([2**32 - 1, 2**32 - 128, 2**24 + 1, 16777217 * 3], np.uint32)
    # random_float steps first; compare on the stepped states
    _, jf = jax_rng.random_float(jnp.asarray(x))
    _, tf = rng.random_float(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


@pytest.mark.parametrize(
    "w,h,kw",
    [
        (48, 32, {}),
        (64, 40, dict(pos=(0.0, 0.3, -1.2), target=(0.0, -0.1, 2.5))),
        (33, 17, dict(pos=(1.0, 2.0, -3.0), target=(-0.3, 0.1, 0.7))),
    ],
)
def test_full_frame_rays_allclose(w, h, kw):
    """Jittered full-frame rays as render_pass makes them."""
    jc = jax_cam.make_camera(w, h, **kw)
    tc = camera.make_camera(w, h, **kw)
    for f in ("pos", "target", "top_left", "top_right", "bottom_left"):
        np.testing.assert_array_equal(getattr(tc, f), np.asarray(getattr(jc, f)))
    seeds = jax_rng.pixel_seeds(jnp.arange(w * h, dtype=jnp.uint32), jnp.uint32(5))
    seeds, jx = jax_rng.random_float(seeds)
    seeds, jy = jax_rng.random_float(seeds)
    want = jax_cam.full_frame_rays(jc, jitter_x=jx, jitter_y=jy)
    o, d, tseeds = pathtracer.camera_rays(tc, 5)
    np.testing.assert_array_equal(tseeds.numpy(), np.asarray(seeds).astype(np.int64))
    np.testing.assert_allclose(o.numpy(), np.asarray(want.o), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(want.d), rtol=0, atol=1e-6)
    plain = jax_cam.full_frame_rays(jc)
    _, d0 = camera.full_frame_rays(tc)
    np.testing.assert_allclose(d0.numpy(), np.asarray(plain.d), rtol=0, atol=1e-6)
