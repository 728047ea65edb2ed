"""The port's film, PNG writer and checkpoints against the JAX package's
`core/film.py` and `utils/checkpoint.py`: the film's mean, 8-bit
conversion and energy on seeded arrays; the PNG read back by PIL and by
the port's own decoder; and checkpoints written by one package and loaded
by the other."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cpu_ray_tracer_tpu.core import film as jax_film
from cpu_ray_tracer_tpu.utils import checkpoint as jax_ckpt
from cpu_ray_tracer_tpu_torch.core import film
from cpu_ray_tracer_tpu_torch.io.image import decode_png, write_png
from cpu_ray_tracer_tpu_torch.utils import checkpoint


def _accum(seed: int, shape=(9, 13, 3)) -> np.ndarray:
    """Radiance sums with values below 0, inside [0, 1] and above 1 after
    the mean, and exact 8-bit boundaries."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.5, 4.0, shape).astype(np.float32)
    a.reshape(-1)[:8] = np.float32(3.0) * np.arange(8, dtype=np.float32) / 255.0
    return a


@pytest.mark.parametrize("spp", [0, 1, 3, 7])
def test_film_matches_jax(spp):
    a = _accum(spp)
    want = jax_film.Film(accum=jnp.asarray(a), spp=jnp.asarray(spp, jnp.int32))
    got = film.Film(accum=torch.from_numpy(a), spp=spp)
    np.testing.assert_array_equal(got.mean().numpy(), np.asarray(want.mean()))
    np.testing.assert_array_equal(film.to_rgb8(got.mean()).numpy(),
                                  np.asarray(jax_film.to_rgb8(want.mean())))
    np.testing.assert_allclose(float(film.energy(got.mean())),
                               float(jax_film.energy(want.mean())), rtol=1e-6)
    assert got.shape == want.shape


def test_make_film_and_add_samples():
    f = film.make_film(4, 6, device="cpu")
    assert f.spp == 0 and f.accum.shape == (4, 6, 3) and not bool(f.accum.any())
    rad = torch.from_numpy(_accum(5, (4, 6, 3)))
    g = film.add_samples(film.add_samples(f, rad, 2), rad, 3)
    want = jax_film.add_samples(jax_film.add_samples(
        jax_film.make_film(4, 6), jnp.asarray(rad.numpy()), 2), jnp.asarray(rad.numpy()), 3)
    assert g.spp == int(want.spp) == 5
    np.testing.assert_array_equal(g.accum.numpy(), np.asarray(want.accum))
    assert f.spp == 0 and not bool(f.accum.any())  # add_samples returns a new film


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (20, 32), (3, 257)])
def test_png_reads_back(tmp_path, shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), img)
    np.testing.assert_array_equal(decode_png(path), img)


def test_png_writer_matches_jax_film_image(tmp_path):
    """A film's 8-bit frame written by both packages decodes to the same
    pixels."""
    a = _accum(11, (10, 16, 3))
    ours, theirs = str(tmp_path / "p.png"), str(tmp_path / "j.png")
    write_png(ours, film.to_rgb8(film.Film(torch.from_numpy(a), 3).mean()).numpy())
    jax_film.write_png(theirs, np.asarray(jax_film.to_rgb8(jnp.asarray(a) / 3.0)))
    np.testing.assert_array_equal(decode_png(ours), decode_png(theirs))


def test_png_writer_refuses_other_layouts(tmp_path):
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4, 4, 3), np.float32)):
        with pytest.raises(ValueError, match="uint8"):
            write_png(str(tmp_path / "bad.png"), bad)


def test_port_checkpoint_loads_in_jax(tmp_path):
    path = str(tmp_path / "film.npz")
    a = _accum(3)
    checkpoint.save_film(path, film.Film(torch.from_numpy(a), 6),
                         extra={"albedo": torch.arange(6.0).reshape(2, 3), "step": 4})
    assert os.listdir(tmp_path) == ["film.npz"]  # the temporary file is moved over
    got, extra = jax_ckpt.load_film(path)
    np.testing.assert_array_equal(np.asarray(got.accum), a)
    assert int(got.spp) == 6 and np.asarray(got.spp).dtype == np.int32
    np.testing.assert_array_equal(np.asarray(extra["albedo"]), np.arange(6.0).reshape(2, 3))
    assert int(extra["step"]) == 4


def test_jax_checkpoint_loads_in_port(tmp_path):
    path = str(tmp_path / "film.npz")
    a = _accum(4)
    jax_ckpt.save_film(path, jax_film.Film(accum=jnp.asarray(a), spp=jnp.asarray(9, jnp.int32)),
                       extra={"lr": jnp.float32(0.05)})
    got, extra = checkpoint.load_film(path, device="cpu")
    assert got.spp == 9 and isinstance(got.spp, int)
    assert got.accum.dtype == torch.float32 and got.accum.device.type == "cpu"
    np.testing.assert_array_equal(got.accum.numpy(), a)
    assert float(extra["lr"]) == pytest.approx(0.05)
    # saved again by the port, it is the same file content
    again = str(tmp_path / "again.npz")
    checkpoint.save_film(again, got, extra={"lr": extra["lr"]})
    with np.load(path) as x, np.load(again) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k])
            assert x[k].dtype == y[k].dtype, k


def test_checkpoint_of_another_format_is_refused(tmp_path):
    path = str(tmp_path / "film.npz")
    np.savez(path, __version__=np.int64(2), accum=np.zeros((2, 2, 3), np.float32),
             spp=np.int32(1))
    with pytest.raises(ValueError, match="format 2"):
        checkpoint.load_film(path, device="cpu")
