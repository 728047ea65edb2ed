"""Gradients of the PyTorch port: `query.find_nearest_diff`, Whitted's
differentiable frame against the JAX package's `jax.grad`, the
finite-difference checks of the JAX package's tests/test_diff.py on the
port's own gradients, and the differentiable forward against the plain
one.  The path tracer's gradients against JAX are in
`test_torch_diff_pt.py`.

The JAX package runs in the port's reference configuration
(`torch_parity`: packed tables, its kernels in interpret mode, the host
routes), the port on the CPU (every walk's plain version), on the scene
carried from the JAX package's (`convert.scene_from_arrays`) with its
parameters carried by `convert.params_from_arrays`.

Tolerances: hits' t, u, v of the differentiable recompute within 2e-5 of
the walk's (relative for t); per-ray gradients and parameter gradients
within `atol = 2e-4 * max|g|, rtol = 1e-3` of JAX's (float32 sums in
another order; the atol covers entries that are rounding residue in both
packages, `torch_grads.G_ATOL`).  Image gradients compare on the pixels
whose forward values agree at the parity tolerance (atol=2e-5,
rtol=1e-4): a pixel beyond it must be fp-borderline
(`render/borderline.py`, a nearest-texel boundary) and is left out of
both losses (`torch_grads.masked_grads`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu.core import camera as jax_cam
from cpu_ray_tracer_tpu.diff import grad as jax_grad
from cpu_ray_tracer_tpu.render import common as jax_common
from cpu_ray_tracer_tpu.render import whitted as jax_whitted
from cpu_ray_tracer_tpu.scene import query as jax_query
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.diff import grad as grad_mod
from cpu_ray_tracer_tpu_torch.ops import kernel_lib
from cpu_ray_tracer_tpu_torch.render import common, pathtracer, whitted
from cpu_ray_tracer_tpu_torch.scene import query
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from cpu_ray_tracer_tpu_torch.scene.convert import params_from_arrays, scene_from_arrays
from torch_grads import ATOL, DEPTH, KEYS, RTOL, assert_grad_close, masked_grads
from torch_parity import (
    BENCH_CAMERA, BENCH_XML, CUBE_XML, jax_compile, jax_reference_env, jax_scene_arrays,
)

WHITTED_CASES = {
    # (xml, bilinear, width, height, camera); bunny_teapot's in
    # test_torch_diff_whitted_bunny.py
    "nearest": (CUBE_XML, False, 16, 10, {}),
    "bilinear": (CUBE_XML, True, 16, 10, {}),
    "bunny_teapot-nearest": (BENCH_XML, False, 64, 40, BENCH_CAMERA),
    "bunny_teapot-bilinear": (BENCH_XML, True, 64, 40, BENCH_CAMERA),
}
VERTEX_KEYS = ("v0", "e1", "e2")


def whitted_case_grads(case):
    """(case, (port grads, JAX grads, pixels left out), tap replay counts
    or None) of a case.  On bunny_teapot in bilinear mode the port's taps
    replay the JAX package's tap positions (`torch_taps`): rounding moves
    a tap by up to ~0.012 texel between the packages there, enough to
    change the texel pair of a tap near an edge, whose uv derivative then
    jumps (texel and vertex gradients up to 1.1e-2 max|g| apart without
    the replay)."""
    xml, bilinear, w, h, cam_kw = WHITTED_CASES[case]
    jax_scene, _ = jax_compile(xml, bilinear=bilinear)
    scene = scene_from_arrays(*jax_scene_arrays(jax_scene))
    cam = cam_mod.make_camera(w, h, **cam_kw)

    def render(sc, o=None, d=None, _=None):
        if o is None:
            return whitted.render(sc, cam, DEPTH, differentiable=True)["image"]
        return whitted.radiance(sc, o, d, DEPTH, differentiable=True)[0]

    stats = {} if bilinear and xml == BENCH_XML else None
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        out = masked_grads(
            lambda s: jax_whitted.render(s, jax_cam.make_camera(w, h, **cam_kw),
                                         depth_limit=DEPTH, differentiable=True)["image"],
            render, jax_scene, scene, (*cam_mod.full_frame_rays(cam, device="cpu"), None),
            replay_stats=stats)
    return case, out, stats


def check_whitted(whitted_grads, key):
    case, (g, g_j, left_out), stats = whitted_grads
    assert left_out.numel() <= 8  # nearest-texel boundaries of the floor
    got, want = g[key].numpy(), np.asarray(g_j[key])
    assert np.isfinite(got).all(), key
    if key in VERTEX_KEYS and case.startswith("bunny"):
        # the JAX package's vertex gradients are NaN for the triangles whose
        # secondary rays miss (the shadow point of a miss at RAY_FAR,
        # ROADMAP queue 3): compare the rows where they are finite
        rows = np.isfinite(want).all(axis=1)
        assert rows.mean() > 0.98, f"{key}: {int((~rows).sum())} rows NaN in JAX"
        got, want = got[rows], want[rows]
    assert_grad_close(got, want, f"{case} {key}")
    if key == "texels":
        # the nearest tap reads the packed atlas, which no parameter feeds
        assert (float(np.abs(got).sum()) > 0) == case.endswith("bilinear")
    elif case.startswith("bunny"):
        # the mirror teapot and the dielectric bunny move every other key
        assert float(np.abs(got).sum()) > 0, key
    if stats is not None:
        # every tap differs by rounding only
        assert stats["taps"] > 0 and stats["kept"] == 0, stats


@pytest.fixture(scope="module", params=["nearest", "bilinear"])
def whitted_grads(request):
    return whitted_case_grads(request.param)


@pytest.mark.parametrize("key", KEYS)
def test_whitted_grads_match_jax(whitted_grads, key):
    check_whitted(whitted_grads, key)


@pytest.fixture(scope="module")
def bunny():
    jax_scene, _ = jax_compile(BENCH_XML)
    scene = scene_from_arrays(*jax_scene_arrays(jax_scene))
    cam = cam_mod.make_camera(64, 40, **BENCH_CAMERA)
    o, d = cam_mod.full_frame_rays(cam, device="cpu")
    return jax_scene, scene, o, d


def test_find_nearest_diff_recomputes_the_walks_hits(bunny):
    _, scene, o, d = bunny
    want = query.find_nearest(scene, o, d)
    got = query.find_nearest_diff(scene, o, d)
    for key in ("obj_idx", "tri_idx", "slot", "mat_id_tri", "traversed", "tested"):
        assert torch.equal(got[key], want[key]), key
    assert int((got["tri_idx"] >= 0).sum()) > 100  # the rays hit triangles
    hit = got["obj_idx"] >= 0
    torch.testing.assert_close(got["t"][hit], want["t"][hit], atol=2e-5, rtol=2e-5)
    for key in ("u", "v"):
        torch.testing.assert_close(got[key], want[key], atol=2e-5, rtol=0.0)


def test_find_nearest_diff_grads_match_jax(bunny, rng):
    """Gradients of a random weighting of t, u, v with respect to the rays
    and the triangle pool, against `jax.grad` of the JAX package's
    `find_nearest_diff`."""
    jax_scene, scene, o, d = bunny
    r = o.shape[0]
    w = rng.standard_normal((r, 3)).astype(np.float32)
    tris = jax_scene.tris

    def jax_f(o, d, v0, e1, e2):
        sc = jax_scene.replace(tris=tris.replace(v0=v0, e1=e1, e2=e2))
        hit = jax_query.find_nearest_diff(sc, o, d)
        far = hit["obj_idx"] < 0  # t of a miss is RAY_FAR, detached
        t = jnp.where(far, 0.0, hit["t"])
        return jnp.sum(w[:, 0] * t + w[:, 1] * hit["bary"][:, 0] + w[:, 2] * hit["bary"][:, 1])

    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        g_j = jax.grad(jax_f, argnums=(0, 1, 2, 3, 4))(
            jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), tris.v0, tris.e1, tris.e2)

    leaves = [x.clone().requires_grad_() for x in
              (o, d, scene.pool[:, 0:3], scene.pool[:, 3:6], scene.pool[:, 6:9])]
    sc = grad_mod.apply_params(scene, dict(zip(("v0", "e1", "e2"), leaves[2:])))
    hit = query.find_nearest_diff(sc, leaves[0], leaves[1])
    t = torch.where(hit["obj_idx"] < 0, 0.0, hit["t"])
    tw = torch.tensor(w)
    (tw[:, 0] * t + tw[:, 1] * hit["u"] + tw[:, 2] * hit["v"]).sum().backward()
    for name, leaf, want in zip(("o", "d", "v0", "e1", "e2"), leaves, g_j):
        assert float(leaf.grad.abs().sum()) > 0, name
        assert_grad_close(leaf.grad.numpy(), want, name)


def test_shadow_term_gradients_stay_finite_past_misses(rng):
    """A difference from the JAX package, on purpose: the masked
    irradiance of a lane left out of the shadow term, whose point is a
    miss's at RAY_FAR, has an infinite distance, and its zero cotangent
    turns into NaN point gradients in the JAX package's
    `direct_illumination` (so its differentiable Whitted frame gives NaN
    vertex gradients on a view with misses).  The port moves such lanes
    below the light: the same irradiance, finite gradients, on which the
    active lanes' agree with JAX's."""
    jax_scene, _ = jax_compile(CUBE_XML)
    scene = scene_from_arrays(*jax_scene_arrays(jax_scene))
    n = 64
    point = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    point[:, 1] = -1.0  # on the floor
    point[:8] = 1e34 * np.float32([0.3, 0.2, 0.9])  # misses at RAY_FAR
    normal = np.tile(np.float32([0.0, 1.0, 0.0]), (n, 1))
    active = np.arange(n) >= 8
    w = rng.standard_normal((n, 3)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)
        want, g_j = jax.value_and_grad(lambda p: jnp.sum(w * jax_common.direct_illumination(
            jax_scene, p, jnp.asarray(normal), jnp.asarray(active))))(jnp.asarray(point))
    assert bool(jnp.isnan(g_j[:8]).any()) and not bool(jnp.isnan(g_j[8:]).any())
    p = torch.tensor(point, requires_grad=True)
    got = (torch.tensor(w) * common.direct_illumination(
        scene, p, torch.tensor(normal), torch.tensor(active))).sum()
    got.backward()
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert bool(torch.isfinite(p.grad).all()) and float(p.grad[:8].abs().max()) == 0.0
    assert_grad_close(p.grad[8:].numpy(), g_j[8:], "point")
    # and so a differentiable Whitted frame's vertex gradients on bunny_teapot
    bunny, _ = compile_scene(BENCH_XML, device="cpu")
    camera = cam_mod.make_camera(32, 20, **BENCH_CAMERA)
    loss_fn = grad_mod.make_loss_fn(
        bunny, lambda s: whitted.render(s, camera, DEPTH, differentiable=True)["image"],
        torch.zeros((20, 32, 3)))
    _, g = grad_mod.value_and_grad(loss_fn, grad_mod.extract_params(bunny, KEYS))
    for key in KEYS:
        assert bool(torch.isfinite(g[key]).all()), key
    assert float(g["v0"].abs().sum()) > 0


@pytest.mark.parametrize("bilinear", [False, True], ids=["nearest", "bilinear"])
@pytest.mark.parametrize("xml,w,h,cam", [(CUBE_XML, 32, 20, {}), (BENCH_XML, 64, 40, BENCH_CAMERA)],
                         ids=["cube_scene", "bunny_teapot"])
def test_differentiable_forward_equals_plain(xml, w, h, cam, bilinear):
    """The differentiable routes (recomputed t and barycentrics, writes out
    of place) render the plain routes' images at the host route
    (`wavefront_depths=0`, the host level): `rays_traced` exact, images at
    the parity tolerance."""
    scene, _ = compile_scene(xml, bilinear=bilinear, device="cpu")
    camera = cam_mod.make_camera(w, h, **cam)
    img, st = pathtracer.render_pass(scene, camera, 5, 3, wavefront_depths=0)
    img_d, st_d = pathtracer.render_pass(scene, camera, 5, 3, differentiable=True)
    assert st_d["rays_traced"] == st["rays_traced"]
    torch.testing.assert_close(img_d, img, atol=ATOL, rtol=RTOL)
    out = whitted.render(scene, camera, 3, level_kernel=False)
    out_d = whitted.render(scene, camera, 3, differentiable=True)
    assert out_d["rays"] == out["rays"] and out_d["levels"] == out["levels"]
    torch.testing.assert_close(out_d["image"], out["image"], atol=ATOL, rtol=RTOL)


def test_differentiable_routes_refuse_the_kernels():
    scene, _ = compile_scene(CUBE_XML, device="cpu")
    camera = cam_mod.make_camera(8, 6)
    with pytest.raises(ValueError):
        pathtracer.render_pass(scene, camera, 0, wavefront_depths=1, differentiable=True)
    with pytest.raises(ValueError):
        whitted.render(scene, camera, level_kernel=True, differentiable=True)
    # a kernel reads pointers outside the graph: it refuses a tracked tensor
    x = torch.zeros(4, 3, requires_grad=True)
    with pytest.raises(ValueError, match="requires grad"):
        kernel_lib.require("closest_hit", x.device, o=(x, torch.float32, (4, 3)))


def test_apply_params_shares_the_rest_of_the_scene():
    scene, _ = compile_scene(CUBE_XML, bilinear=True, device="cpu")
    params = grad_mod.extract_params(scene, KEYS)
    params["albedo"] = params["albedo"] * 0.5
    params["e1"] = params["e1"] + 1.0
    new = grad_mod.apply_params(scene, params)
    assert new.mat_albedo is params["albedo"] and new.atlas_texels is params["texels"]
    assert torch.equal(new.pool[:, 3:6], params["e1"])
    assert torch.equal(new.pool[:, 6:9], scene.pool[:, 6:9])
    assert new.node_records is scene.node_records and new.bilinear
    assert torch.equal(scene.mat_albedo[2], params["albedo"][2] * 2)  # the source is unchanged
    # the fused kernels' packed materials follow the new table
    assert not torch.equal(new.kernel_params, scene.kernel_params)
    assert not new.kernel_params.requires_grad
    with pytest.raises(ValueError):
        grad_mod.apply_params(scene, {"albedo": params["albedo"][:2]})


def test_params_round_trip_through_arrays():
    """`extract_params` -> numpy -> `params_from_arrays` gives the same
    tensors, and a scene carried with `meta["bilinear"]` keeps its tap."""
    jax_scene, _ = jax_compile(CUBE_XML, bilinear=True)
    arrays, meta = jax_scene_arrays(jax_scene)
    assert meta["bilinear"]
    scene = scene_from_arrays(arrays, meta)
    assert scene.bilinear and not scene.stack_kernels
    params = grad_mod.extract_params(scene, KEYS)
    back = params_from_arrays({k: v.numpy() for k, v in params.items()})
    assert back.keys() == params.keys()
    for k in KEYS:
        assert back[k].dtype == torch.float32 and torch.equal(back[k], params[k]), k
    jparams = jax_grad.extract_params(jax_scene, keys=KEYS)
    carried = params_from_arrays({k: np.asarray(v) for k, v in jparams.items()})
    for k in KEYS:
        assert torch.equal(carried[k], params[k]), k


# --- finite differences (tests/test_diff.py:34-121, on the port) ---------


@pytest.fixture(scope="module")
def setup():
    scene, _ = compile_scene(CUBE_XML, bilinear=True, device="cpu")
    return scene, cam_mod.make_camera(16, 10)


def whitted_image(scene, cam):
    return whitted.render(scene, cam, DEPTH, differentiable=True)["image"]


def whitted_loss(setup):
    scene, cam = setup
    return grad_mod.make_loss_fn(scene, lambda s: whitted_image(s, cam),
                                 torch.zeros((cam.height, cam.width, 3)))


def check_fd(setup, key, indices, eps, atol, rtol):
    scene, _ = setup
    params = grad_mod.extract_params(scene, keys=(key,))
    loss_fn = whitted_loss(setup)
    _, g = grad_mod.value_and_grad(loss_fn, params)
    g = g[key].reshape(-1)
    for idx in indices:
        want = float(grad_mod.finite_difference(loss_fn, params, key, idx, eps=eps))
        got = float(g[idx])
        assert abs(got - want) <= atol + rtol * abs(want), f"{key}[{idx}]: {got} vs fd {want}"
    return g


def test_albedo_gradients_match_fd(setup):
    g = check_fd(setup, "albedo", [2 * 3 + 0, 2 * 3 + 1, 2 * 3 + 2], 1e-3, 5e-5, 5e-2)
    assert float(g.abs().max()) > 0


def test_light_color_gradients_match_fd(setup):
    check_fd(setup, "light_color", [0, 1, 2], 1e-2, 1e-5, 5e-2)


def test_texel_gradients_flow_and_match_fd(setup):
    scene, _ = setup
    params = grad_mod.extract_params(scene, keys=("texels",))
    loss_fn = whitted_loss(setup)
    _, g = grad_mod.value_and_grad(loss_fn, params)
    g = g["texels"]
    assert int((g.abs() > 0).any(dim=-1).sum()) > 10  # many floor and sky texels
    flat = g.reshape(-1)
    idx = int(flat.abs().argmax())
    want = float(grad_mod.finite_difference(loss_fn, params, "texels", idx, eps=1e-2))
    assert abs(float(flat[idx]) - want) <= 1e-5 + 0.05 * abs(want)


def test_vertex_gradients_flow(setup):
    scene, _ = setup
    params = grad_mod.extract_params(scene, keys=("v0", "e1", "e2"))
    _, g = grad_mod.value_and_grad(whitted_loss(setup), params)
    total = sum(float(v.abs().sum()) for v in g.values())
    assert np.isfinite(total) and total > 0


def _pt_loss(setup, spp_index):
    scene, cam = setup
    return grad_mod.make_loss_fn(
        scene, lambda s: pathtracer.render_pass(s, cam, spp_index, DEPTH, differentiable=True)[0],
        torch.zeros((cam.height, cam.width, 3)))


def test_pt_gradients_finite(setup):
    scene, _ = setup
    params = grad_mod.extract_params(scene, keys=("albedo", "texels", "light_color"))
    _, g = grad_mod.value_and_grad(_pt_loss(setup, 0), params)
    for k, v in g.items():
        assert bool(torch.isfinite(v).all()), k
    assert float(g["albedo"].abs().sum()) > 0


def test_pt_grad_matches_fd_fixed_seed(setup):
    """At a fixed seed the path tracer's estimate is a deterministic
    function, and its gradient matches finite differences."""
    scene, _ = setup
    params = grad_mod.extract_params(scene, keys=("albedo",))
    loss_fn = _pt_loss(setup, 7)
    _, g = grad_mod.value_and_grad(loss_fn, params)
    idx = 2 * 3 + 1
    want = float(grad_mod.finite_difference(loss_fn, params, "albedo", idx, eps=1e-3))
    got = float(g["albedo"].reshape(-1)[idx])
    assert abs(got - want) <= 1e-5 + 0.05 * abs(want), (got, want)
