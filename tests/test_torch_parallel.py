"""Data parallelism of the PyTorch port (`parallel/mesh.py`,
`parallel/sharded.py`, `diff/optimize.make_sharded_train_step`, the CLI's
`--sharded`) on the CPU: 2 and 4 ranks, each a process of its own
(`tests/torch_ranks.py`) joined over gloo by a `FileStore`, on
`cube_scene.xml` at 32x16 as `tests/test_distributed.py` runs the JAX
package's on its 8-device CPU mesh.

* The gathered image equals the port's unsharded `sample_radiance` over
  the same seeds, and the JAX package's `sharded_render_pass`, at atol
  1e-5, rtol 1e-5 (`tests/test_distributed.py:65`), on the kernels' route
  and on the reference route (the JAX package's CPU route); every rank
  holds the same image, and `rays_traced` is the frame's.
* Each rank traces only its block: the ray batches it saw.
* The sharded train step's loss and updated parameters equal the port's
  single-device step and the JAX package's `make_sharded_train_step` at
  rtol 1e-5, atol 1e-6 (`tests/test_distributed.py:110-116`), after one
  step and after two (the second Adam step depends on the gradients'
  size), also with a [K, H, W, 3] target; the all-reduced gradients of
  the first step equal the single-device step's and `jax.grad` of the
  frame's loss; three steps lower the loss.
* A pixel count that does not divide by the world size raises.
* The CLI's `--sharded` in a world of one writes the PNG it writes without.

Every spawned rank has a join timeout of its own; stragglers are killed
and the test fails.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cpu_ray_tracer_tpu.diff import grad as jax_grad
from cpu_ray_tracer_tpu.diff import optimize as jax_optimize
from cpu_ray_tracer_tpu.parallel import mesh as jax_mesh
from cpu_ray_tracer_tpu.parallel import sharded as jax_sharded
from cpu_ray_tracer_tpu.core import camera as jax_cam
from cpu_ray_tracer_tpu.render import pathtracer as jax_pt
from cpu_ray_tracer_tpu_torch.accel import native
from cpu_ray_tracer_tpu_torch.cli import main
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.diff import grad as grad_mod
from cpu_ray_tracer_tpu_torch.diff.optimize import make_train_step
from cpu_ray_tracer_tpu_torch.io.image import decode_png
from cpu_ray_tracer_tpu_torch.parallel import mesh as mesh_mod
from cpu_ray_tracer_tpu_torch.render import pathtracer
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from torch_parity import CUBE_XML, jax_compile_reference, jax_reference_env
import torch_ranks
from torch_ranks import DEPTH, H, KEYS, LR, LR_DESCENT, W

JOIN_SECONDS = 120
ROUTES = {"kernels": {}, "reference": dict(use_pallas=False)}


def _spawn(world: int, tmp) -> list[dict]:
    """Run `world` ranks of tests/torch_ranks.py; their saved results in
    rank order."""
    native.load()  # built once here, not by every rank at once
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.dirname(torch_ranks.__file__), os.path.dirname(os.path.dirname(
            torch_ranks.__file__))]))
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    store = str(tmp / "store")
    procs = [subprocess.Popen([sys.executable, torch_ranks.__file__, str(r), str(world), store,
                               str(tmp)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs, late = [], []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=JOIN_SECONDS)[0])
        except subprocess.TimeoutExpired:
            late.append(p)
            logs.append("")
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()
    assert not late, f"{len(late)} of {world} ranks did not finish in {JOIN_SECONDS} s"
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module", params=[2, 4], ids=["2-ranks", "4-ranks"])
def ranks(request, tmp_path_factory):
    return request.param, _spawn(request.param, tmp_path_factory.mktemp(f"w{request.param}"))


@pytest.fixture(scope="module")
def port_scenes():
    return {k: compile_scene(CUBE_XML, device="cpu", **kw)[0] for k, kw in ROUTES.items()}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's sharded pass and sharded train steps on its
    8-device CPU mesh, over its CPU route's scene."""
    assert len(jax.devices()) == 8
    scene, _ = jax_compile_reference(CUBE_XML)
    cam = jax_cam.make_camera(W, H)
    mesh = jax_mesh.make_mesh()
    one, stack = (jnp.asarray(t.numpy()) for t in torch_ranks.targets())
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        out["image"] = np.asarray(jax_sharded.sharded_render_pass(scene, cam, mesh)(
            jnp.uint32(0)))
        opt = optax.adam(LR)
        params = jax_grad.extract_params(scene, keys=KEYS)
        for key, target, index in (("step", one, 0), ("crn", stack, 3)):
            step = jax_optimize.make_sharded_train_step(scene, cam, target, opt, mesh,
                                                        depth_limit=DEPTH)(params)
            p, state, loss = step(params, opt.init(params), jnp.uint32(index))
            out[f"{key}.loss"] = float(loss)
            out[f"{key}.params"] = {k: np.asarray(v) for k, v in p.items()}
            if key == "step":
                p, _, loss = step(p, state, jnp.uint32(1))
                out["step2.loss"] = float(loss)
                out["step2.params"] = {k: np.asarray(v) for k, v in p.items()}

            # the frame's loss on one device at the step's sample index
            # and target (common random numbers: index % K, target index % K)
            sample, tgt = (index % 2, target[1]) if key == "crn" else (index, target)

            def frame_loss(p, sample=sample, tgt=tgt):
                img, _ = jax_pt.render_pass(jax_grad.apply_params(scene, p), cam,
                                            jnp.uint32(sample), depth_limit=DEPTH,
                                            differentiable=True)
                return jax_grad.l2_image_loss(img, tgt)

            out[f"{key}.grads"] = {k: np.asarray(v) for k, v in
                                   jax.grad(frame_loss)(params).items()}
    return out


def _unsharded(scene):
    o, d, seeds = pathtracer.camera_rays(cam_mod.make_camera(W, H), 0, "cpu")
    img, st = pathtracer.sample_radiance(scene, o, d, seeds)
    return img.reshape(H, W, 3), st


@pytest.mark.parametrize("route", list(ROUTES))
def test_sharded_image_equals_unsharded_and_jax(ranks, port_scenes, jax_side, route):
    world, outs = ranks
    want, st = _unsharded(port_scenes[route])
    got = outs[0][f"{route}.image"]
    assert got.shape == (H, W, 3) and bool(torch.isfinite(got).all())
    for o in outs[1:]:
        assert torch.equal(o[f"{route}.image"], got)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    assert all(o[f"{route}.rays"] == st["rays_traced"] for o in outs)
    if route == "kernels":
        # (the reference route's counters add the walks of dead rays at
        # every depth its batch runs, and a block may end its loop sooner)
        assert torch.equal(outs[0][f"{route}.traversed"], st["traversed"])
    else:
        np.testing.assert_allclose(got.numpy(), jax_side["image"], atol=1e-5, rtol=1e-5)


def test_each_rank_traces_its_block(ranks):
    world, outs = ranks
    per = W * H // world
    for r, o in enumerate(outs):
        assert (o["rank"], o["world"], o["backend"]) == (r, world, "gloo")
        for route in ROUTES:
            assert o[f"{route}.shapes"] == [(per, 3)]
        rays = torch.arange(2 * W * H * 3, dtype=torch.float32).reshape(-1, 3)
        assert torch.equal(o["shard_rays"], rays[r * 2 * per:(r + 1) * 2 * per])
        # psum of rank + 1 over the ranks
        assert o["psum"].tolist() == [world * (world + 1) / 2] * 3


def _assert_params(got, want):
    assert got.keys() == set(KEYS)
    for k in KEYS:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), atol=1e-6,
                                   rtol=1e-5, err_msg=k)


def _assert_grads(got, want):
    """Gradients summed over the ranks against the frame's: at rtol 1e-5
    and 1e-6 of the largest |g|, as the ranks sum their blocks' terms in
    another order than one device sums the frame's."""
    assert got.keys() == set(KEYS)
    for k in KEYS:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(g, w, atol=1e-6 * np.abs(w).max(), rtol=1e-5, err_msg=k)


def _snapshot(step):
    return ({k: v.detach().clone() for k, v in step.params.items()},
            {k: v.grad.clone() for k, v in step.params.items()})


def test_sharded_train_step_matches_single_device_and_jax(ranks, port_scenes, jax_side):
    """One and two steps: the first Adam step moves each parameter by about
    lr sign(g) whatever the gradient's size, so the gradients the step
    took are compared too, and the parameters after a second step, which
    depends on the first gradient's size against the second's."""
    world, outs = ranks
    scene = port_scenes["reference"]
    cam = cam_mod.make_camera(W, H)
    one, stack = torch_ranks.targets()
    params = grad_mod.extract_params(scene, KEYS)
    single = make_train_step(scene, cam, one, params, LR, DEPTH, device="cpu")
    loss = float(single(0))
    single_params, single_grads = _snapshot(single)
    loss2 = float(single(1))
    # common random numbers: step 3 of a 2-stack is the single step at
    # sample index 1 against the second target
    crn_single = make_train_step(scene, cam, stack[1], params, LR, DEPTH, device="cpu")
    crn_loss = float(crn_single(1))
    crn_params, crn_grads = _snapshot(crn_single)
    for o in outs:
        assert o["step.loss"] == pytest.approx(loss, rel=1e-5)
        assert o["step.loss"] == pytest.approx(jax_side["step.loss"], rel=1e-5)
        _assert_grads(o["step.grads"], single_grads)
        _assert_grads(o["step.grads"], jax_side["step.grads"])
        _assert_params(o["step.params"], single_params)
        _assert_params(o["step.params"], jax_side["step.params"])
        assert o["step2.loss"] == pytest.approx(loss2, rel=1e-5)
        assert o["step2.loss"] == pytest.approx(jax_side["step2.loss"], rel=1e-5)
        _assert_params(o["step2.params"], {k: v.detach() for k, v in single.params.items()})
        _assert_params(o["step2.params"], jax_side["step2.params"])
        assert o["crn.loss"] == pytest.approx(crn_loss, rel=1e-5)
        assert o["crn.loss"] == pytest.approx(jax_side["crn.loss"], rel=1e-5)
        _assert_grads(o["crn.grads"], crn_grads)
        _assert_grads(o["crn.grads"], jax_side["crn.grads"])
        _assert_params(o["crn.params"], crn_params)
        _assert_params(o["crn.params"], jax_side["crn.params"])
    # the ranks stay equal
    for o in outs[1:]:
        for k in KEYS:
            assert torch.equal(o["step.params"][k], outs[0]["step.params"][k])
            assert torch.equal(o["step2.params"][k], outs[0]["step2.params"][k])


def test_three_steps_lower_the_loss(ranks):
    world, outs = ranks
    losses = outs[0]["descent"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert all(o["descent"] == losses for o in outs)
    assert LR_DESCENT > LR


def test_indivisible_pixel_count_raises(ranks):
    world, outs = ranks
    for o in outs:
        assert o["odd"] == f"495 pixels do not divide among {world} ranks"


def test_world_of_one_and_its_refusals(port_scenes):
    """Without a launcher `make_mesh` makes a world of one (and closes it);
    a world size other than the launcher's raises and names torchrun; the
    card is the default device."""
    mesh = mesh_mod.make_mesh(device="cpu")
    try:
        assert (mesh.rank, mesh.world, mesh.backend, mesh.owned) == (0, 1, "gloo", True)
        assert mesh_mod.replicate_scene(port_scenes["kernels"], mesh).device.type == "cpu"
        assert mesh.block(W * H) == (0, W * H)
    finally:
        mesh.close()
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        mesh_mod.make_mesh(4, device="cpu")
    assert not torch.distributed.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_mod.make_mesh()


def test_cli_sharded_world_of_one_writes_the_same_png(tmp_path):
    argv = ["--scene-xml", CUBE_XML, "--integrator", "pathtracer", "--spp", "2", "--width",
            str(W), "--height", str(H), "--device", "cpu"]
    assert main(argv + ["--out", str(tmp_path / "a.png")]) == 0
    assert main(argv + ["--sharded", "true", "--out", str(tmp_path / "b.png"),
                        "--metrics-jsonl", str(tmp_path / "b.jsonl")]) == 0
    assert np.array_equal(decode_png(str(tmp_path / "a.png")), decode_png(str(tmp_path / "b.png")))
    assert '"world": 1' in open(tmp_path / "b.jsonl").readline()
    assert not torch.distributed.is_initialized()
