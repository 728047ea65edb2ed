"""The port's progressive loop (`render/progressive.py`) and metrics
(`utils/metrics.py`) against the JAX package's: the same records a step,
the checkpoint cadence, resume equal to an uninterrupted run, and the
traversal summary of the same counters."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu.core import camera as jax_cam
from cpu_ray_tracer_tpu.render import progressive as jax_progressive
from cpu_ray_tracer_tpu.utils import metrics as jax_metrics
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.core import film as film_mod
from cpu_ray_tracer_tpu_torch.ops import kernel_lib
from cpu_ray_tracer_tpu_torch.render import pathtracer, progressive
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from cpu_ray_tracer_tpu_torch.utils import checkpoint, metrics
from torch_parity import CUBE_XML, jax_compile, jax_reference_env

W, H = 16, 10


@pytest.fixture(scope="module")
def scene():
    return compile_scene(CUBE_XML, device="cpu")[0]


def _records(path):
    return [json.loads(line) for line in open(path).read().strip().splitlines()]


def test_records_match_jax(tmp_path, scene):
    jax_scene, _ = jax_compile(CUBE_XML)
    jl_jax, jl_port = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        logger = jax_metrics.JsonlLogger(jl_jax)
        want = jax_progressive.render_progressive(jax_scene, jax_cam.make_camera(W, H), 3,
                                                  logger=logger)
        logger.close()
    logger = metrics.JsonlLogger(jl_port)
    got = progressive.render_progressive(scene, cam_mod.make_camera(W, H), 3, logger=logger)
    logger.close()
    assert got.spp == int(want.spp) == 3
    np.testing.assert_allclose(got.accum.numpy(), np.asarray(want.accum), atol=2e-5, rtol=1e-4)
    ours, theirs = _records(jl_port), _records(jl_jax)
    assert [set(r) for r in ours] == [set(r) for r in theirs]
    for a, b in zip(ours, theirs):
        assert a["step"] == b["step"] and a["rays_traced"] == b["rays_traced"]
        assert a["energy"] == pytest.approx(b["energy"], rel=1e-5)
        assert a["total_tests"] > 0


def test_checkpoint_cadence_and_resume(tmp_path, scene):
    """Saved every 2 samples; a run resumed from the 2-sample checkpoint
    ends on the accumulator of an uninterrupted run."""
    camera = cam_mod.make_camera(W, H)
    path = str(tmp_path / "film.npz")
    whole = progressive.render_progressive(scene, camera, 5, checkpoint_path=path,
                                           checkpoint_every=2)
    assert checkpoint.load_film(path, device="cpu")[0].spp == 4
    part = progressive.render_progressive(scene, camera, 2)
    resumed = progressive.render_progressive(scene, camera, 5, film=part)
    assert resumed.spp == 5
    torch.testing.assert_close(resumed.accum, whole.accum, atol=0.0, rtol=0.0)
    # nothing left to do: the film comes back as it was
    same = progressive.render_progressive(scene, camera, 5, film=resumed)
    assert same.spp == 5 and torch.equal(same.accum, resumed.accum)


def test_render_fn_hook(scene):
    """`render_fn` replaces the pass (the sharded pass of the JAX package
    drops in here); a bare image counts as a sample without stats."""
    camera = cam_mod.make_camera(W, H)
    seen = []

    def render_fn(s, c, i):
        seen.append(i)
        return pathtracer.render_pass(s, c, i, samples_per_pass=1)[0]

    film = progressive.render_progressive(scene, camera, 3, render_fn=render_fn)
    assert seen == [0, 1, 2] and film.spp == 3
    want = progressive.render_progressive(scene, camera, 3)
    torch.testing.assert_close(film.accum, want.accum, atol=0.0, rtol=0.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_traversal_summary_matches_jax(seed):
    rng = np.random.default_rng(seed)
    tr = rng.integers(0, 40, (H, W)).astype(np.int32)
    tr[0] = 0
    te = rng.integers(0, 90, (H, W)).astype(np.int32)
    got = metrics.traversal_summary(torch.from_numpy(tr), torch.from_numpy(te))
    want = jax_metrics.traversal_summary(jnp.asarray(tr), jnp.asarray(te))
    assert got == want


def test_frame_metrics_match_jax():
    """The same smoothing of the same frame times (the clock patched)."""
    ours, theirs = metrics.FrameMetrics(64, 40, device="cpu"), jax_metrics.FrameMetrics(64, 40)
    for dt in (0.020, 0.010, 0.040, 0.015):
        recs = []
        for fm in (ours, theirs):
            fm.start()
            fm._t0 -= dt
            recs.append(fm.stop())
        assert recs[0].keys() == recs[1].keys()
        for k in recs[0]:
            assert recs[0][k] == pytest.approx(recs[1][k], rel=1e-3), k


def test_runtime_flags_state_what_ran():
    flags = metrics.runtime_flags("cpu")
    # the native builder loads (as the JAX package's runtime_flags reports it)
    assert flags == dict(device="cpu", kernel_library=None, native=True, sbvh=False)
    for kw, native, sbvh in ((dict(), True, False), (dict(sbvh=True), True, True),
                             (dict(builder="numpy"), False, False)):
        _, info = compile_scene(CUBE_XML, device="cpu", **kw)
        got = metrics.runtime_flags("cpu", info)
        assert (got["native"], got["sbvh"]) == (native, sbvh), kw
    if torch.cuda.is_available():
        cuda = metrics.runtime_flags("cuda")
        assert cuda["device"] == torch.cuda.get_device_name(0)
        assert cuda["kernel_library"] == kernel_lib.library_path().rsplit("/", 1)[-1]


def test_jsonl_logger(tmp_path):
    path = str(tmp_path / "m.jsonl")
    logger = metrics.JsonlLogger(path)
    logger.log(dict(step=1, ms=2.5))
    logger.log(dict(step=2))
    logger.close()
    assert _records(path) == [dict(step=1, ms=2.5), dict(step=2)]
    silent = metrics.JsonlLogger("")
    silent.log(dict(step=1))
    silent.close()


def test_film_on_the_scene_device(scene):
    film = progressive.render_progressive(scene, cam_mod.make_camera(W, H), 1)
    assert film.accum.device == scene.device
    assert float(film_mod.energy(film.mean())) > 0
