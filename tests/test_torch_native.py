"""The port's native (C++) BVH builders (`accel/native.py`, its copy of
the sources in `native/crt_native.cpp`) against the JAX package's
(`cpu_ray_tracer_tpu/accel/native.py`, compiled from native/ with the
same flags):

* the binned-SAH build's tables, the SBVH build's and the threaded links
  are byte-equal to the JAX package's, for random soups, a soup of
  slivers and the bunny and teapot meshes, at leaf sizes 24, None (2)
  and 8 and force_split_cap 4 and None; an SBVH whose reference cap
  trips gives None in both, and `build_bvh(sbvh=True)` then the plain
  SAH tree, as the JAX package's `CRT_SBVH=1`;
* `compile_scene` with the native builder (the default) equals the JAX
  package's with its library loaded, for the TLAS, mono and shared
  layouts, the reference route and the SBVH (`CRT_SBVH=1`); with
  `builder="numpy"` it equals the JAX package's `CRT_NATIVE=0`;
* the 8-wide collapse of an SBVH scene equals the JAX package's
  (`CRT_SBVH=1` with `CRT_WIDE=1`) and renders the binary SBVH's pass;
* a path-tracer pass and a Whitted frame over an SBVH scene at 64x40
  equal the JAX package's (`rays_traced` exact, the images at atol 2e-5,
  rtol 1e-4 with the nudge rule of `render/borderline.py`);
* a g++ failure raises with its output; no numpy tree comes back.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu.accel import native as jax_native
from cpu_ray_tracer_tpu.core import camera as jax_cam
from cpu_ray_tracer_tpu.render import pathtracer as jax_pt
from cpu_ray_tracer_tpu.render import whitted as jax_whitted
from cpu_ray_tracer_tpu_torch.accel import bvh_builder, native
from cpu_ray_tracer_tpu_torch.core import camera as cam_mod
from cpu_ray_tracer_tpu_torch.io.obj import load_obj
from cpu_ray_tracer_tpu_torch.render import borderline, pathtracer, whitted
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene
from cpu_ray_tracer_tpu_torch.scene.convert import reference_tables, scene_from_arrays
from torch_parity import (
    BENCH_CAMERA, BENCH_XML, CUBE_XML, OUR_ASSETS, assert_wide_tables_equal, jax_compile,
    jax_compile_reference, jax_compile_wide, jax_reference_env, jax_scene_arrays, jax_walk_arrays,
)

FIELDS = ("node_min", "node_max", "left_first", "tri_count", "left", "right", "axis")


@pytest.fixture(scope="module", autouse=True)
def jax_library():
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp)  # asserts that the JAX package's library loads


def _soup(seed, n):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-4, 4, size=(n, 1, 3))
    return (base + rng.normal(0, 0.4, size=(n, 3, 3))).astype(np.float32)


def _slivers(seed=0):
    """The soup of tests/test_accel.py's SBVH case: 64 diagonal slivers
    and 236 small local triangles."""
    rng = np.random.default_rng(seed)
    slivers = []
    for i in range(64):
        y0 = -3.0 + 3.0 * i / 63.0
        z = float(np.sin(i)) * 0.5
        slivers.append([[-4.0, y0, z], [4.0, y0 + 3.0, z + 0.02], [4.0, y0 + 3.02, z]])
    small = rng.uniform(-3, 3, size=(236, 1, 3)) + rng.normal(0, 0.1, size=(236, 3, 3))
    return np.concatenate([np.asarray(slivers, np.float32), small.astype(np.float32)])


@functools.lru_cache(maxsize=None)
def _mesh(name):
    return load_obj(os.path.join(OUR_ASSETS, f"{name}.obj")).triangles()[0].astype(
        np.float32)


TRIS = {
    "soup200": lambda: _soup(1, 200),
    "soup1000": lambda: _soup(2, 1000),
    "slivers": _slivers,
    "bunny": lambda: _mesh("bunny"),
    "teapot": lambda: _mesh("teapot"),
}


def _assert_trees_equal(ours, theirs):
    (h, idx, st), (jh, jidx, jst) = ours, theirs
    assert h.nodes_used == jh.nodes_used
    for k in FIELDS:
        a, b = getattr(h, k), getattr(jh, k)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    assert idx.tobytes() == jidx.tobytes()
    for k in ("max_depth", "num_nodes", "num_leaves", "max_leaf"):
        assert getattr(st, k) == getattr(jst, k), k
    return h


@pytest.mark.parametrize("leaf_target, cap",
                         [(24, 4), (None, None), (8, 4), (None, 4), (24, None)],
                         ids=["24-cap4", "ref", "8-cap4", "None-cap4", "24-nocap"])
@pytest.mark.parametrize("tris", list(TRIS))
def test_sah_tables_and_links_equal_jax(tris, leaf_target, cap):
    tri_v = TRIS[tris]()
    h = _assert_trees_equal(
        bvh_builder.build_bvh(tri_v, cap, leaf_target),
        jax_native.build_bvh_native(tri_v, force_split_cap=cap, leaf_target=leaf_target))
    links = bvh_builder.thread_links(h.left, h.right, h.tri_count, h.axis)
    want = jax_native.thread_links_native(h.left, h.right, h.tri_count, h.axis)
    for a, b in zip(links, want):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("leaf_target", [8, 24])
@pytest.mark.parametrize("tris", list(TRIS))
def test_sbvh_tables_equal_jax(tris, leaf_target):
    tri_v = TRIS[tris]()
    ours = bvh_builder.build_bvh(tri_v, leaf_target=leaf_target, sbvh=True)
    h = _assert_trees_equal(ours, jax_native.build_sbvh_native(tri_v, leaf_target=leaf_target))
    idx = ours[1]
    # every triangle is referenced, some of them more than once on the meshes
    assert set(idx.tolist()) == set(range(tri_v.shape[0]))
    if tris in ("bunny", "teapot"):
        assert idx.shape[0] > tri_v.shape[0]
    # children's boxes lie in their parent's (the SBVH's invariant), and a
    # forest of two SBVHs threads alike in both packages
    inner = np.nonzero(h.tri_count == 0)[0]
    for ch in (h.left[inner], h.right[inner]):
        assert (h.node_min[ch] >= h.node_min[inner]).all()
        assert (h.node_max[ch] <= h.node_max[inner]).all()
    m = h.nodes_used
    two = [np.concatenate([a, np.where(a >= 0, a + m, a)]) if k in ("left", "right")
           else np.concatenate([a, a]) for k, a in (("left", h.left), ("right", h.right),
                                                   ("tri_count", h.tri_count), ("axis", h.axis))]
    got = bvh_builder.thread_links(*two, roots=[0, m])
    want = jax_native.thread_links_native(*two, roots=[0, m])
    assert all(a.tobytes() == b.tobytes() for a, b in zip(got, want))


def test_sbvh_cap_trips_to_the_sah_tree(monkeypatch):
    """A reference cap below the triangle count trips in both packages
    (None); `build_bvh(sbvh=True)` then builds the plain SAH tree, as the
    JAX package's `CRT_SBVH=1` does."""
    tri_v = _slivers()
    assert native.build_sbvh_native(tri_v, ref_factor=0.0) is None
    assert jax_native.build_sbvh_native(tri_v, ref_factor=0.0) is None
    monkeypatch.setattr(native, "build_sbvh_native",
                        functools.partial(native.build_sbvh_native, ref_factor=0.0))
    ours = bvh_builder.build_bvh(tri_v, leaf_target=8, sbvh=True)
    from cpu_ray_tracer_tpu.accel import bvh_builder as jax_bvh

    monkeypatch.setattr(jax_native, "build_sbvh_native",
                        functools.partial(jax_native.build_sbvh_native, ref_factor=0.0))
    monkeypatch.setenv("CRT_SBVH", "1")
    _assert_trees_equal(ours, jax_bvh.build_bvh(tri_v, leaf_target=8))
    _assert_trees_equal(ours, bvh_builder.build_bvh(tri_v, leaf_target=8))
    assert ours[1].shape[0] == tri_v.shape[0]


def test_numpy_builder_equals_jax_numpy(monkeypatch):
    """`builder="numpy"` is the JAX package's `CRT_NATIVE=0` build."""
    from cpu_ray_tracer_tpu.accel import bvh_builder as jax_bvh

    tri_v = TRIS["bunny"]()
    monkeypatch.setenv("CRT_NATIVE", "0")
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    for lt, cap in ((24, 4), (None, None)):
        ours = bvh_builder.build_bvh(tri_v, cap, lt, builder="numpy")
        jh, jidx, jst = jax_bvh.build_bvh(tri_v, force_split_cap=cap, leaf_target=lt)
        _assert_trees_equal(ours, (jh.trim(), jidx, jst))
        # the default, native, build is another tree: float32 SAH costs
        assert bvh_builder.build_bvh(tri_v, cap, lt)[1].tobytes() != ours[1].tobytes()
    with pytest.raises(ValueError, match="no numpy SBVH"):
        bvh_builder.build_bvh(tri_v, builder="numpy", sbvh=True)
    with pytest.raises(ValueError, match="no numpy SBVH"):
        compile_scene(CUBE_XML, builder="numpy", sbvh=True, device="cpu")
    with pytest.raises(ValueError, match="expected 'native' or 'numpy'"):
        bvh_builder.build_bvh(tri_v, builder="cuda")


def _assert_state_equal(ours, theirs):
    want, got = ours.state_dict(), theirs.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), k
    if ours.shared is None:
        assert (ours.root, ours.depth) == (theirs.root, theirs.depth)


# (port compile_scene options, JAX jax_compile options)
SCENES = {
    "tlas": (dict(), dict()),
    "mono": (dict(layout="mono"), dict(layout="mono")),
    "shared": (dict(instancing="shared"), dict(instancing="shared")),
    "tlas-sbvh": (dict(sbvh=True), dict(sbvh=True)),
    "mono-sbvh": (dict(layout="mono", sbvh=True), dict(layout="mono", sbvh=True)),
    "shared-sbvh": (dict(instancing="shared", sbvh=True), dict(instancing="shared", sbvh=True)),
    "tlas-numpy": (dict(builder="numpy"), dict(numpy=True)),
    "mono-numpy": (dict(layout="mono", builder="numpy"), dict(layout="mono", numpy=True)),
}


@pytest.mark.parametrize("case", list(SCENES))
def test_compile_scene_equals_jax(case):
    ours_kw, jax_kw = SCENES[case]
    jax_scene, jax_info = jax_compile(BENCH_XML, **jax_kw)
    port, info = compile_scene(BENCH_XML, device="cpu", **ours_kw)
    _assert_state_equal(port, scene_from_arrays(*jax_scene_arrays(jax_scene)))
    assert info.triangle_count == jax_info.triangle_count
    assert info.max_tree_depth == jax_info.max_tree_depth
    assert (info.builder, info.sbvh) == (ours_kw.get("builder", "native"),
                                         ours_kw.get("sbvh", False))
    if "sbvh" in case and "shared" not in case:
        assert port.tris.shape[0] > info.triangle_count  # repeated references


@pytest.mark.parametrize("layout, sbvh", [("tlas", False), ("mono", False), ("tlas", True)],
                         ids=["tlas", "mono", "tlas-sbvh"])
def test_reference_route_equals_jax(layout, sbvh):
    """`use_pallas=False` (leaves of 2; the SBVH's leaves of 8) against the
    JAX package's XLA route with its native builder."""
    jax_scene, jax_info = jax_compile_reference(BENCH_XML, layout=layout, sbvh=sbvh)
    port, info = compile_scene(BENCH_XML, layout=layout, use_pallas=False, sbvh=sbvh,
                               device="cpu")
    arrays, ref = jax_walk_arrays(jax_scene.tris, "bvh", jax_scene.bvh)
    (ours,), (theirs,) = port.reference.structs, reference_tables(arrays, ref).structs
    a, b = dict(ours.named_buffers()), dict(theirs.named_buffers())
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert (ours.max_leaf, ours.max_depth, ours.root) == (theirs.max_leaf, theirs.max_depth,
                                                          theirs.root)
    assert info.max_tree_depth == jax_info.max_tree_depth
    assert (ours.tri_indices.shape[0] > info.triangle_count) == sbvh


W, H = 64, 40


@pytest.fixture(scope="module")
def sbvh_pair():
    jax_scene, _ = jax_compile(BENCH_XML, sbvh=True)
    port, _ = compile_scene(BENCH_XML, sbvh=True, device="cpu")
    return jax_scene, port


def test_path_tracer_over_sbvh_matches_jax(sbvh_pair):
    jax_scene, port = sbvh_pair
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp, sbvh=True)
        img, st = jax_pt.render_pass(jax_scene, jax_cam.make_camera(W, H, **BENCH_CAMERA),
                                     jnp.uint32(1))
        ref, rays = np.asarray(img), int(st["rays_traced"])
    camera = cam_mod.make_camera(W, H, **BENCH_CAMERA)
    got, stats = pathtracer.render_pass(port, camera, 1)
    assert stats["rays_traced"] == rays
    assert int(stats["traversed"].sum()) > 0
    cmp = borderline.unexplained_pixels(
        lambda o, d, s: pathtracer.sample_radiance(port, o, d, s)[0],
        pathtracer.camera_rays(camera, 1, "cpu"), got, torch.from_numpy(ref))
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()


@pytest.mark.parametrize("level_kernel", [True, False], ids=["kernel_route", "host_route"])
def test_whitted_over_sbvh_matches_jax(sbvh_pair, level_kernel):
    jax_scene, port = sbvh_pair
    with pytest.MonkeyPatch.context() as mp:
        jax_reference_env(mp, sbvh=True)
        mp.setenv("CRT_WHITTED_WF", "0")
        out = jax_whitted.render(jax_scene, jax_cam.make_camera(W, H, **BENCH_CAMERA))
        ref = np.asarray(out["image"])
    camera = cam_mod.make_camera(W, H, **BENCH_CAMERA)
    got = whitted.render(port, camera, level_kernel=level_kernel)
    assert got["dropped"] == 0 and int(out["dropped"]) == 0 and got["rays"] > 0
    cmp = borderline.unexplained_pixels(
        lambda o, d, _: whitted.radiance(port, o, d, level_kernel=level_kernel)[0],
        (*cam_mod.full_frame_rays(camera, device="cpu"), None), got["image"],
        torch.from_numpy(ref.copy()))
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()


def test_failed_compiler_raises(tmp_path, monkeypatch):
    """A g++ failure raises with the compiler's output: no library, and no
    numpy tree in its place."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXXFLAGS", native.CXXFLAGS + ["-fno-such-flag"])
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*-fno-such-flag"):
            native.load()
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            bvh_builder.build_bvh(_soup(3, 50))
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            compile_scene(CUBE_XML, device="cpu")
        monkeypatch.setattr(native, "CXX", str(tmp_path / "no-compiler"))
        with pytest.raises(RuntimeError, match="failed to start"):
            native.load()
        assert os.listdir(tmp_path) == []  # no half-written library left behind
    finally:
        native.load.cache_clear()


def test_library_name_hashes_source_flags_and_cpu(monkeypatch):
    path = native.library_path()
    assert path.startswith(native.BUILD_DIR) and path.endswith(".so")
    assert os.path.dirname(native.SOURCE).endswith(os.path.join("cpu_ray_tracer_tpu_torch",
                                                                "native"))
    assert native.CXXFLAGS == ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]
    monkeypatch.setattr(native, "CXXFLAGS", ["-O2"])
    assert native.library_path() != path
    monkeypatch.undo()
    monkeypatch.setattr(native, "cpu_flags", lambda: "sse2")
    assert native.library_path() != path


def test_refit_of_an_sbvh_matches_jax():
    """`refit_bvh` on an SBVH (repeated references) gives the JAX package's
    bounds, which contain every moved triangle of each leaf."""
    from cpu_ray_tracer_tpu.accel import bvh_builder as jax_bvh

    tri_v = TRIS["teapot"]()
    host, idx, _ = bvh_builder.build_bvh(tri_v, leaf_target=8, sbvh=True)
    jhost, jidx, _ = jax_native.build_sbvh_native(tri_v, leaf_target=8)
    moved = tri_v + np.random.default_rng(5).normal(0, 0.01, size=(tri_v.shape[0], 1, 3)).astype(
        np.float32)
    bvh_builder.refit_bvh(host, idx, moved)
    jax_bvh.refit_bvh(jhost, jidx, moved)
    assert host.node_min.tobytes() == jhost.node_min.tobytes()
    assert host.node_max.tobytes() == jhost.node_max.tobytes()
    leaf = np.nonzero(host.tri_count > 0)[0]
    for n in leaf:
        sl = idx[host.left_first[n]: host.left_first[n] + host.tri_count[n]]
        assert (host.node_min[n] <= moved[sl].min(axis=(0, 1))).all()
        assert (host.node_max[n] >= moved[sl].max(axis=(0, 1))).all()


@pytest.fixture(scope="module")
def jax_sbvh_wide():
    return jax_compile_wide(BENCH_XML, sbvh=True)[0]


@pytest.mark.parametrize("wide", [True, "bounce"])
def test_wide_collapse_of_an_sbvh(sbvh_pair, jax_sbvh_wide, wide):
    """The 8-wide collapse of an SBVH scene (repeated references) equals
    the JAX package's (`CRT_SBVH=1` with `CRT_WIDE=1`), and renders the
    binary SBVH's pass."""
    _, port = sbvh_pair
    wide_scene, info = compile_scene(BENCH_XML, sbvh=True, wide=wide, device="cpu")
    assert wide_scene.tris.shape[0] > info.triangle_count  # repeated references
    assert_wide_tables_equal(jax_sbvh_wide, wide_scene)
    camera = cam_mod.make_camera(W, H, **BENCH_CAMERA)
    want, st = pathtracer.render_pass(port, camera, 2)
    got, st_wide = pathtracer.render_pass(wide_scene, camera, 2)
    assert st_wide["rays_traced"] == st["rays_traced"]
    cmp = borderline.unexplained_pixels(
        lambda o, d, s: pathtracer.sample_radiance(wide_scene, o, d, s)[0],
        pathtracer.camera_rays(camera, 2, "cpu"), got, want)
    assert cmp["unexplained"].numel() == 0, cmp["unexplained"].tolist()
