"""The port's command-line renderer (`python -m cpu_ray_tracer_tpu_torch.cli`)
on the CPU (`--device cpu`, the kernels' plain versions).

* The three cases of the JAX package's `tests/test_cli.py` against the
  port.
* The port's CLI against the JAX package's on the same argv: PNGs within
  one 8-bit level except pixels whose path the nudge probe shows
  fp-borderline (`render/borderline.py`), the same JSONL keys, and
  checkpoints that resume across the packages.  The JAX CLI renders on its
  CPU defaults (the XLA traversals over the reference's leaves of 2); the
  port builds its kernels' tables (leaves of up to 24), so hits agree up
  to ties.
* `--instancing shared` (one BVH per unique mesh) against the JAX CLI on
  the same argv, under the same rule.
* `--use-pallas false` (the reference walks) against the JAX CLI on the
  same argv, for both scenes and both integrators on the BVH and for the
  grid and KD forests: the same rule for the PNGs, and the JSONL's
  traversal and test totals, means and peaks equal, record by record.
  Where a record's differ, every ray whose counters differ between the
  packages' renders of that frame must be fp-borderline in a float64
  evaluation (`torch_rays.counter_borderline`): on `cube_scene` the
  triangles lie in their leaves' box faces, so a leaf's slab test against
  the ray's best t is a tie that rounding decides.  The test prints how
  many such rays there are.
* `--sharded true --n-devices 2` in a world of one raises and names
  torchrun (one process drives one device; `tests/test_torch_parallel.py`
  runs the sharded CLI).
* The JSONL's first record states what ran: the native builder, the
  SBVH option, and under `--sharded` the world size.
"""

import json
import os

import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu.cli import main as jax_main
from cpu_ray_tracer_tpu.utils import checkpoint as jax_ckpt
from cpu_ray_tracer_tpu_torch.cli import main
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.io.image import decode_png
from cpu_ray_tracer_tpu_torch.render import basics, borderline, pathtracer, whitted
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from cpu_ray_tracer_tpu_torch.utils import checkpoint as ckpt
from torch_parity import BENCH_XML, CUBE_XML

BENCH_CAM = ["--cam-pos", "0,0.3,-1.2", "--cam-target", "0,-0.1,2.5"]
CPU = ["--device", "cpu"]


def _records(path):
    """The step and frame records of a CLI's JSONL, without the port's
    first record, which states what ran (`test_first_record_states_what_ran`;
    the JAX CLI writes none)."""
    recs = [json.loads(line) for line in open(path).read().strip().splitlines()]
    return [r for r in recs if "runtime" not in r]


# --- the JAX package's tests/test_cli.py, against the port -----------------

@pytest.mark.parametrize("xml", [CUBE_XML, BENCH_XML], ids=["cube_scene", "bunny_teapot"])
def test_whitted_writes_png_and_metrics(tmp_path, xml):
    out = str(tmp_path / "w.png")
    jl = str(tmp_path / "m.jsonl")
    rc = main(["--scene-xml", xml, "--integrator", "whitted", "--width", "32", "--height", "20",
               "--out", out, "--metrics-jsonl", jl, *CPU])
    assert rc == 0
    assert os.path.getsize(out) > 100
    rec = _records(jl)[-1]
    assert rec["total_tests"] > 0
    # the port counts interior steps per ray: cube_scene's 12 triangles
    # make one leaf at the kernels' leaf size, and no ray takes a step
    assert (rec["total_traversal"] > 0) == (xml == BENCH_XML)


def test_pt_checkpoint_resume(tmp_path):
    out = str(tmp_path / "p.png")
    ck = str(tmp_path / "film.npz")
    argv = ["--scene-xml", CUBE_XML, "--integrator", "pathtracer", "--width", "16",
            "--height", "8", "--out", out, "--checkpoint", ck, "--checkpoint-every", "1", *CPU]
    assert main(argv + ["--spp", "2"]) == 0
    film, _ = ckpt.load_film(ck, device="cpu")
    assert film.spp == 2
    # resume to 4 spp: the accumulator continues, it does not restart
    assert main(argv + ["--spp", "4"]) == 0
    film2, _ = ckpt.load_film(ck, device="cpu")
    assert film2.spp == 4
    assert float(film2.accum.abs().sum()) > float(film.accum.abs().sum())


def test_grid_accel_cli(tmp_path):
    out = str(tmp_path / "g.png")
    rc = main(["--scene-xml", CUBE_XML, "--integrator", "basics", "--aov", "depth",
               "--layout", "mono", "--accel", "grid", "--width", "16", "--height", "8",
               "--out", out, *CPU])
    assert rc == 0
    assert decode_png(out).shape == (8, 16, 3)


# --- the port's CLI against the JAX package's -------------------------------

W, H = 32, 20
# (argv, the port's radiance along camera rays, and those rays)
CASES = {
    "whitted-cube": (["--scene-xml", CUBE_XML, "--integrator", "whitted"], "whitted"),
    "whitted-bunny-mono": (["--scene-xml", BENCH_XML, "--integrator", "whitted",
                            "--layout", "mono", *BENCH_CAM], "whitted"),
    "pathtracer-bunny": (["--scene-xml", BENCH_XML, "--integrator", "pathtracer", "--spp", "1",
                          *BENCH_CAM], "pathtracer"),
    "basics-normal-bunny-kdtree": (["--scene-xml", BENCH_XML, "--integrator", "basics",
                                    "--aov", "normal", "--accel", "kdtree", *BENCH_CAM],
                                   "basics"),
    "basics-albedo-cube-mono-grid": (["--scene-xml", CUBE_XML, "--integrator", "basics",
                                      "--layout", "mono", "--accel", "grid"], "basics"),
}


def _option(argv, flag, default):
    return argv[argv.index(flag) + 1] if flag in argv else default


def _port_radiance(argv, kind):
    """(radiance(o, d, seeds), (o, d, seeds)) of the frame the argv renders,
    through the port on the CPU."""
    kwargs = dict(layout=_option(argv, "--layout", "tlas"), accel=_option(argv, "--accel", "bvh"),
                  instancing=_option(argv, "--instancing", "baked"),
                  use_pallas=False if _option(argv, "--use-pallas", "auto") == "false" else None)
    scene, _ = compile_scene(_option(argv, "--scene-xml", None), device="cpu", **kwargs)
    cam = dict(pos=(0.0, 0.0, -2.0), target=(0.0, 0.0, -1.0))
    if "--cam-pos" in argv:
        cam = dict(pos=tuple(float(x) for x in _option(argv, "--cam-pos", "").split(",")),
                   target=tuple(float(x) for x in _option(argv, "--cam-target", "").split(",")))
    camera = cam_mod.make_camera(W, H, **cam)
    if kind == "pathtracer":
        return (lambda o, d, s: pathtracer.sample_radiance(scene, o, d, s)[0],
                pathtracer.camera_rays(camera, 0, "cpu"))
    o, d = cam_mod.full_frame_rays(camera, device="cpu")
    if kind == "whitted":
        return (lambda oo, dd, _: whitted.radiance(scene, oo, dd)[0]), (o, d, None)
    aov = _option(argv, "--aov", "albedo")
    return (lambda oo, dd, _: basics.aov_of_rays(scene, oo, dd, aov)), (o, d, None)


@pytest.mark.parametrize("case", list(CASES))
def test_png_matches_jax_cli(tmp_path, case):
    _matches_jax_cli(tmp_path, *CASES[case])


def test_shared_instancing_matches_jax_cli(tmp_path):
    """`--instancing shared` renders, and matches the JAX CLI's frame (its
    XLA traversal per instance) under the rule above."""
    _matches_jax_cli(tmp_path, ["--scene-xml", BENCH_XML, "--integrator", "whitted",
                                "--instancing", "shared", *BENCH_CAM], "whitted")


REFERENCE = ["--use-pallas", "false"]
REFERENCE_CASES = {
    "pathtracer-cube": (["--scene-xml", CUBE_XML, "--integrator", "pathtracer", "--spp", "2"],
                        "pathtracer"),
    "whitted-cube": (["--scene-xml", CUBE_XML, "--integrator", "whitted"], "whitted"),
    "pathtracer-bunny": (["--scene-xml", BENCH_XML, "--integrator", "pathtracer", "--spp", "1",
                          *BENCH_CAM], "pathtracer"),
    "whitted-bunny": (["--scene-xml", BENCH_XML, "--integrator", "whitted", *BENCH_CAM],
                      "whitted"),
    "whitted-bunny-grid": (["--scene-xml", BENCH_XML, "--integrator", "whitted", "--accel",
                            "grid", *BENCH_CAM], "whitted"),
    "pathtracer-bunny-mono-kdtree": (["--scene-xml", BENCH_XML, "--integrator", "pathtracer",
                                      "--spp", "1", "--layout", "mono", "--accel", "kdtree",
                                      *BENCH_CAM], "pathtracer"),
}
COUNTERS = ("total_traversal", "average_traversal", "peak_traversal", "total_tests",
            "average_tests", "peak_tests")


@pytest.mark.parametrize("case", list(REFERENCE_CASES))
def test_reference_walks_match_jax_cli(tmp_path, case):
    """`--use-pallas false`: the reference walks, counters and all."""
    argv, kind = REFERENCE_CASES[case]
    ours, theirs = _matches_jax_cli(tmp_path, argv + REFERENCE, kind)
    assert all(r["total_traversal"] > 0 and r["total_tests"] > 0 for r in ours)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        if {k: a[k] for k in COUNTERS} != {k: b[k] for k in COUNTERS}:
            n = _borderline_counter_rays(argv + REFERENCE, kind, i, a)
            print(f"{case} record {i}: {n} fp-borderline rays with other counters")


def _borderline_counter_rays(argv, kind, spp_index, record) -> int:
    """The rays whose counters differ between the packages' renders of the
    frame behind JSONL record `spp_index` (a path-tracer pass, or the
    Whitted frame's primary rays): assert that each is fp-borderline and
    that the port's render gives the record; return their count."""
    from cpu_ray_tracer_tpu.core import camera as jax_cam
    from cpu_ray_tracer_tpu.render import pathtracer as jax_pt
    from cpu_ray_tracer_tpu.render import whitted as jax_whitted
    from cpu_ray_tracer_tpu_torch.utils import metrics
    from torch_parity import jax_compile_reference, jax_reference_env
    from torch_rays import counter_borderline

    argv = argv + ["--width", str(W), "--height", str(H)]
    kwargs = dict(layout=_option(argv, "--layout", "tlas"), accel=_option(argv, "--accel", "bvh"))
    scene, _ = compile_scene(_option(argv, "--scene-xml", None), use_pallas=False, device="cpu",
                             **kwargs)
    jax_scene, _ = jax_compile_reference(_option(argv, "--scene-xml", None), **kwargs)
    cam = dict(pos=(0.0, 0.0, -2.0), target=(0.0, 0.0, -1.0))
    if "--cam-pos" in argv:
        cam = dict(pos=tuple(float(x) for x in _option(argv, "--cam-pos", "").split(",")),
                   target=tuple(float(x) for x in _option(argv, "--cam-target", "").split(",")))
    camera, jcamera = cam_mod.make_camera(W, H, **cam), jax_cam.make_camera(W, H, **cam)
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        if kind == "pathtracer":
            _, st = jax_pt.render_pass(jax_scene, jcamera, np.uint32(spp_index))
            o, d, seeds = pathtracer.camera_rays(camera, spp_index, "cpu")

            def counters(sc, oo, dd):
                _, stats = pathtracer.sample_radiance(sc, oo, dd, seeds)
                return torch.stack([stats["traversed"], stats["tested"]], dim=-1)
        else:
            st = jax_whitted.render(jax_scene, jcamera)
            o, d = cam_mod.full_frame_rays(camera, device="cpu")
            counters = None
    ours = (pathtracer.render_pass(scene, camera, spp_index)[1] if kind == "pathtracer"
            else whitted.render(scene, camera))
    assert {k: record[k] for k in COUNTERS} == metrics.traversal_summary(
        ours["traversed"], ours["tested"])
    differ = np.zeros(W * H, bool)
    for k in ("traversed", "tested"):
        differ |= ours[k].numpy().reshape(-1) != np.asarray(st[k]).reshape(-1)
    assert differ.any()
    unexplained = np.nonzero(differ & ~counter_borderline(scene, o, d, counters))[0]
    assert unexplained.size == 0, unexplained.tolist()
    return int(differ.sum())


def _matches_jax_cli(tmp_path, argv, kind):
    """Render `argv` through both CLIs and hold the PNGs and the JSONL
    keys to the module docstring's rule; (port records, JAX records)."""
    argv = argv + ["--width", str(W), "--height", str(H)]
    ours, theirs = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    jl_ours, jl_theirs = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    assert main(argv + ["--out", ours, "--metrics-jsonl", jl_ours, *CPU]) == 0
    assert jax_main(argv + ["--out", theirs, "--metrics-jsonl", jl_theirs]) == 0
    a, b = decode_png(ours).astype(np.int32), decode_png(theirs).astype(np.int32)
    assert a.shape == b.shape == (H, W, 3)
    bad = np.nonzero((np.abs(a - b) > 1).any(axis=-1).reshape(-1))[0]
    if bad.size:
        radiance, (o, d, seeds) = _port_radiance(argv, kind)
        idx = torch.from_numpy(bad)
        moved = borderline.nudge_sensitive(radiance, o[idx], d[idx],
                                           None if seeds is None else seeds[idx])
        assert bool(moved.all()), f"pixels {bad[~moved.numpy()].tolist()} differ beyond one level"
    if kind == "basics":
        return None
    ours_rec, theirs_rec = _records(jl_ours), _records(jl_theirs)
    assert len(ours_rec) == len(theirs_rec) >= 1
    assert [set(r) for r in ours_rec] == [set(r) for r in theirs_rec]
    return ours_rec, theirs_rec


def test_checkpoints_resume_across_packages(tmp_path):
    """A film the JAX CLI checkpointed at 1 spp resumes in the port's CLI to
    2 spp (the port's pass 1 added to it), and one the port checkpointed
    resumes in the JAX CLI: the JAX film then differs from its own 2-spp
    film only where the packages' first passes do, at fp-borderline
    pixels."""
    argv = ["--scene-xml", CUBE_XML, "--integrator", "pathtracer", "--width", "16",
            "--height", "8", "--checkpoint-every", "1", "--out", str(tmp_path / "x.png")]
    j1, p1 = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    assert jax_main(argv + ["--spp", "1", "--checkpoint", j1]) == 0
    start, _ = ckpt.load_film(j1, device="cpu")
    assert main(argv + ["--spp", "2", "--checkpoint", j1, *CPU]) == 0
    resumed, _ = ckpt.load_film(j1, device="cpu")
    assert resumed.spp == 2
    scene, _ = compile_scene(CUBE_XML, device="cpu")
    camera = cam_mod.make_camera(16, 8)
    torch.testing.assert_close(resumed.accum, start.accum + pathtracer.render_pass(scene, camera, 1)[0],
                               atol=0.0, rtol=0.0)

    assert main(argv + ["--spp", "1", "--checkpoint", p1, *CPU]) == 0
    port_pass0, _ = ckpt.load_film(p1, device="cpu")
    assert jax_main(argv + ["--spp", "2", "--checkpoint", p1]) == 0
    jax_resumed, _ = jax_ckpt.load_film(p1)
    assert int(jax_resumed.spp) == 2
    j2 = str(tmp_path / "jax2.npz")
    assert jax_main(argv + ["--spp", "2", "--checkpoint", j2]) == 0
    jax_own, _ = jax_ckpt.load_film(j2)
    diff = torch.from_numpy(np.array(jax_resumed.accum) - np.array(jax_own.accum))
    near = torch.isclose(torch.from_numpy(np.array(jax_resumed.accum)),
                         torch.from_numpy(np.array(jax_own.accum)), atol=4e-5, rtol=2e-4)
    bad = torch.nonzero(~near.all(-1).reshape(-1)).squeeze(1)
    if bad.numel():
        o, d, seeds = pathtracer.camera_rays(camera, 0, "cpu")
        moved = borderline.nudge_sensitive(
            lambda oo, dd, ss: pathtracer.sample_radiance(scene, oo, dd, ss)[0],
            o[bad], d[bad], seeds[bad])
        assert bool(moved.all()), (bad.tolist(), diff.reshape(-1, 3)[bad].tolist())
    assert port_pass0.spp == 1


@pytest.mark.parametrize("flag, item", [
    (["--sharded", "true", "--n-devices", "2"], "torchrun --nproc-per-node 2"),
], ids=["flag0-item 14"])
def test_unported_flags_raise(tmp_path, flag, item):
    """The sharded CLI is ported; a world size the run cannot have raises
    and says how to start the processes."""
    with pytest.raises(ValueError, match=item):
        main(["--scene-xml", CUBE_XML, "--width", "8", "--height", "4",
              "--out", str(tmp_path / "x.png"), *flag, *CPU])
    assert not torch.distributed.is_initialized()  # the mesh it made is closed


@pytest.mark.parametrize("sharded", [False, True], ids=["plain", "sharded"])
def test_first_record_states_what_ran(tmp_path, sharded):
    jl = str(tmp_path / "m.jsonl")
    assert main(["--scene-xml", CUBE_XML, "--spp", "1", "--width", "8", "--height", "4",
                 "--out", str(tmp_path / "x.png"), "--metrics-jsonl", jl, *CPU,
                 *(["--sharded", "true"] if sharded else [])]) == 0
    recs = [json.loads(line) for line in open(jl).read().strip().splitlines()]
    want = dict(device="cpu", kernel_library=None, native=True, sbvh=False)
    if sharded:
        want["world"] = 1
    assert recs[0] == dict(runtime=want)
    assert [r["step"] for r in recs[1:]] == [1]


def test_scene_is_required():
    assert main(["--integrator", "basics", *CPU]) == 2


def test_device_defaults_to_the_card(tmp_path):
    """Without `--device` the CLI renders on the card, and without one it
    raises rather than fall back to the CPU."""
    argv = ["--scene-xml", CUBE_XML, "--integrator", "basics", "--width", "8", "--height", "4",
            "--out", str(tmp_path / "x.png")]
    if torch.cuda.is_available():
        assert main(argv) == 0
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
