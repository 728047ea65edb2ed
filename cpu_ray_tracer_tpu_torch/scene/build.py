"""Host-side scene compiler: XML spec -> DeviceScene.

The port of the JAX package's `cpu_ray_tracer_tpu/scene/build.py`.  With
`instancing="baked"` (the default) it has two layouts, the reference's two
XML scene classes:

* `layout="tlas"`: TLASFileScene (infra/scene/tlas_file_scene.cpp), one
  tree per object (its scale baked into the vertices, then its rigid
  transform applied), every instance baked into world space;
* `layout="mono"`: FileScene (infra/scene/file_scene.cpp), every object's
  triangles transformed by its full T @ S and merged under ONE tree
  (scene/build.py:194-262 there).  Normals take the inverse-transpose and
  are normalised; `parity=True` keeps the reference's quirk, the
  rotation-transpose of the full matrix (model.cpp:57, :70-72).

The three accelerators are interchangeable and give the same hits:

* `accel="bvh"`: on `tlas` all BLAS nodes fused under the TLAS into one
  node forest (`_build_unified_tlas`, scene/build.py:601-702 there), on
  `mono` one BVH with root 0; either is walked by the binary stack walk;
  `wide=True` collapses it into 8-wide nodes for the wide walk, and
  `wide="bounce"` keeps the binary walk for the wavefront and Whitted
  kernels and sends only the host queries wide (the JAX package's
  `CRT_WIDE=1` / `bounce`, scene/build.py:379-440);
* `accel="grid"` / `"kdtree"`: a grid or KD tree per instance over its
  world-baked triangles (`mono`: one over all triangles), compiled to cell
  trees and merged into one forest walked by hit/miss links
  (scene/build.py:281-333 there).

`instancing="shared"` (TLAS layout, BVH only) keeps one object-space BVH
per unique mesh and a table of instance transforms instead
(`_build_shared_instances`, scene/build.py:465-598 there): the
reference's BLASBVH with its O(1) SetTransform (`scene/types.py`
SharedInstances, `scene/animate.py`); queries move the rays into each
instance's object space (`scene/query.py`).

`use_pallas=False` builds the reference route instead (the JAX package's
XLA traversals, scene/build.py:101-110, :225-302 there): the reference's
BVH leaves of 2 (`leaf_target` None unless given), the grid or KD tree of
each instance (one on `mono`) as the builders give them, and the
reference walks' tables (`scene/types.ReferenceTables`, `accel/
compile.py`), walked in plain PyTorch by `ops/traverse_bvh.py`,
`ops/traverse_grid.py`, `ops/traverse_kd.py` and `ops/forest.py` with the
reference's per-ray counters; no kernel table is built.  None and True
build the kernels' tables (the port's "auto" takes the kernels on every
device, where the JAX package's takes them on a TPU only).

`force_split_cap` and the BVH leaf size (`leaf_target`) are the builder's
(`accel/bvh_builder.py`; `leaf_target` None: the route's, 24 for the
kernels and the reference's 2 for the reference walks).  `builder`
picks the BVH builder of every tree the scene holds: "native" (the
default, the JAX package's: the C++ build of `accel/native.py`) or
"numpy" (the JAX package's `CRT_NATIVE=0`); `sbvh=True` builds each BVH
as an SBVH (native only; the JAX package's `CRT_SBVH=1`), whose leaves
may repeat a triangle.  The JAX package reads both from the environment;
the port takes them as arguments, as it takes `wide`.  `parity=True`
takes the reference route with the reference's SAH stop
(`force_split_cap=None`), as the JAX package's parity mode does.  Node
numbering, builds and the leaf triangle order are the JAX package's, so
the two packages' tables compare one to one.
"""

from __future__ import annotations

import numpy as np

from cpu_ray_tracer_tpu_torch import constants
from cpu_ray_tracer_tpu_torch.accel import (
    bvh_builder, cell_tree, grid_builder, kdtree_builder, pack, tlas_builder, wide as wide_mod,
)
from cpu_ray_tracer_tpu_torch.accel.compile import (
    bvh_arrays, make_triangle_pool, shading_records, tree_tables,
)
from cpu_ray_tracer_tpu_torch.core import device as device_mod
from cpu_ray_tracer_tpu_torch.core import vecmath as vm
from cpu_ray_tracer_tpu_torch.core.materials import make_table
from cpu_ray_tracer_tpu_torch.core.textures import build_atlas
from cpu_ray_tracer_tpu_torch.io.image import load_texture_image
from cpu_ray_tracer_tpu_torch.io.obj import load_obj
from cpu_ray_tracer_tpu_torch.io.scene_xml import load_scene_xml, resolve_asset
from cpu_ray_tracer_tpu_torch.scene.types import (
    DeviceScene, ReferenceTables, SceneInfo, SharedInstances,
)

DEG2RAD = np.float32(np.pi / 180.0)
LIGHT_SIZE = 0.5  # half-extent of the light's Quad(0, 1) (tlas_file_scene.cpp:15-19)


def _object_matrix(obj) -> np.ndarray:
    """The object's rigid transform T (its scale is baked into vertices)."""
    return (
        vm.mat_translate(obj.position)
        @ vm.mat_rotate_x(float(obj.rotation[0]) * DEG2RAD)
        @ vm.mat_rotate_y(float(obj.rotation[1]) * DEG2RAD)
        @ vm.mat_rotate_z(float(obj.rotation[2]) * DEG2RAD)
    )


def compile_scene(
    xml_path: str | None = None, spec=None, layout: str = "tlas", accel: str = "bvh",
    instancing: str = "baked", parity: bool = False,
    force_split_cap: int | None = bvh_builder.FORCE_SPLIT_CAP, shadow_quirk: bool = True,
    wide: bool | str = False, bilinear: bool = False, leaf_target: int | None = None,
    use_pallas: bool | None = None, builder: str = "native", sbvh: bool = False,
    device=device_mod.DEFAULT,
) -> tuple[DeviceScene, SceneInfo]:
    """Compile an XML scene, or a parsed `spec` (`io/scene_xml.SceneSpec`,
    which `scene/animate.AnimatedScene` edits), to a DeviceScene on
    `device` (the card unless the caller asks for another; without a CUDA
    device the default raises).  `layout` "tlas" or "mono"; `accel` "bvh",
    "grid" or "kdtree"; `instancing` "baked" or "shared" (TLAS layout and
    BVH only, not wide; module docstring); `wide` False, True or "bounce"
    for "bvh" on the kernels' route; `use_pallas` False for the reference
    walks (module docstring); `parity` the reference's normals and BVH
    stops on the reference route; `force_split_cap` and `leaf_target` the
    BVH builder's (None: the reference's SAH stop; the route's leaf size);
    `builder` "native" or "numpy" and `sbvh` the BVH builds' (module
    docstring); `shadow_quirk` as the JAX package's; `bilinear` picks the bilinear
    texture tap, which carries texel gradients and keeps the scene off the
    wavefront and Whitted level kernels (`DeviceScene` doc)."""
    dev = device_mod.resolve(device)
    if parity:
        use_pallas, force_split_cap = False, None  # the reference-exact route
    reference = use_pallas is False
    if reference and wide:
        # the JAX package builds no wide tables for its XLA traversals
        raise ValueError(f"wide={wide!r} with use_pallas=False: the reference walks take the "
                         "binary BVH")
    if leaf_target is None and not reference:
        leaf_target = bvh_builder.LEAF_TARGET
    bvh_builder.check_builder(builder, sbvh)
    bvh_opts = dict(force_split_cap=force_split_cap, leaf_target=leaf_target, builder=builder,
                    sbvh=sbvh)
    if layout not in ("tlas", "mono"):
        raise ValueError(f"layout={layout!r}: expected 'tlas' or 'mono'")
    if instancing not in ("baked", "shared"):
        raise ValueError(f"instancing={instancing!r}: expected 'baked' or 'shared'")
    if accel not in ("bvh", "grid", "kdtree"):
        raise ValueError(f"accel={accel!r}: expected 'bvh', 'grid' or 'kdtree'")
    if wide not in (False, True, "bounce") or (wide and accel != "bvh"):
        raise ValueError(f"wide={wide!r} with accel={accel!r}: wide is False, True or "
                         "'bounce', and only for accel='bvh'")
    if instancing == "shared" and (layout != "tlas" or accel != "bvh" or wide):
        # the JAX package's refusal (scene/build.py:160-164 there); it has
        # no wide shared tables either
        raise ValueError("instancing='shared' requires layout='tlas' and accel='bvh', "
                         f"and no wide tables (got layout={layout!r}, accel={accel!r}, "
                         f"wide={wide!r})")
    if spec is None:
        spec = load_scene_xml(xml_path)
    xml_dir = spec.xml_dir

    # ---- textures ----------------------------------------------------
    images = []

    def add_tex(path_str: str) -> int:
        images.append(load_texture_image(resolve_asset(path_str, xml_dir)))
        return len(images) - 1

    floor_tex = add_tex(spec.plane_texture_location)
    mat_tex_ids = [add_tex(m.texture_location) if m.texture_location else -1 for m in spec.materials]
    skydome_tex = add_tex(spec.skydome_location)
    atlas = build_atlas(images)
    floor_tex_width = images[floor_tex].shape[1]

    # ---- materials ----------------------------------------------------
    rows = [{"is_light": True}, {"tex_id": floor_tex}]  # slots 0 (light), 1 (floor)
    for m, tid in zip(spec.materials, mat_tex_ids):
        rows.append(
            {
                "reflectivity": m.reflectivity,
                "refractivity": m.refractivity,
                "absorption": tuple(m.absorption),
                "tex_id": tid,
            }
        )
    rows.append({"albedo": (255 / 255.0, 192 / 255.0, 203 / 255.0)})  # error pink
    materials = make_table(rows)
    light_t = vm.mat_translate(tuple(spec.light_pos))
    lights = dict(
        materials=materials, atlas=atlas, light_t=light_t,
        light_inv_t=vm.mat_inverted_no_scale(light_t), light_size=LIGHT_SIZE,
        light_color=constants.LIGHT_COLOR, floor_inv_to=100.0 / floor_tex_width,
        skydome_tex=skydome_tex, shadow_quirk=shadow_quirk, bilinear=bilinear,
    )
    if instancing == "shared":
        pool, shared, ref, info = _build_shared_instances(spec, bvh_opts, reference)
        return DeviceScene(packed=None, pool=pool, shared=shared, reference=ref,
                           **lights).to(dev), info

    inst_v, inst_n, inst_uv, inst_obj, inst_mat = _instances(spec, layout, parity)
    all_v = np.concatenate(inst_v, axis=0)
    all_n = np.concatenate(inst_n, axis=0)
    all_uv = np.concatenate(inst_uv, axis=0)
    ids = dict(obj_id=np.concatenate(inst_obj), mat_id=np.concatenate(inst_mat))
    if reference:
        return _reference_scene(spec, layout, accel, inst_v, all_v, all_n, all_uv, ids,
                                bvh_opts, lights, dev)

    v0 = all_v[:, 0]
    e1 = all_v[:, 1] - v0
    e2 = all_v[:, 2] - v0
    shade16 = shading_records(all_v, all_n, all_uv)
    wide_pack = None
    if accel == "bvh":
        if layout == "mono":
            h, idx, build_stats = bvh_builder.build_bvh(all_v, **bvh_opts)
            host = tree_tables(h, idx)
            blas_stats = []
        else:
            host, build_stats, blas_stats = _build_unified_tlas(inst_v, **bvh_opts)
        packed = pack.pack_bvh(**host, tri_v=all_v, shade16=shade16, **ids)
        if wide:
            wide_pack = wide_mod.pack_wide(
                host["node_min"], host["node_max"], host["left"], host["right"],
                host["tri_count"], host["root"],
                packed.nodes[:, pack.N_FIRST], packed.nodes[:, pack.N_COUNT], packed.leaf_codes,
            )
    else:
        # mono: one tree over all triangles
        packed, blas_stats = _build_cell_forest(
            accel, [all_v] if layout == "mono" else inst_v, all_v, shade16, ids)
        # mono: the one tree's build; tlas: no BVH over the instances
        build_stats = blas_stats.pop() if layout == "mono" else bvh_builder.BuildStats()

    scene = DeviceScene(
        packed=packed,
        pool=np.concatenate([v0, e1, e2], axis=1),
        wide=wide_pack,
        wide_bounce=wide == "bounce",
        **lights,
    )
    info = SceneInfo(
        name=spec.name,
        triangle_count=int(all_v.shape[0]),
        object_count=len(spec.objects),
        num_nodes=int(packed.nodes.shape[0]),
        tree_depth=packed.depth,
        build_stats=build_stats,
        blas_stats=blas_stats,
        builder=builder,
        sbvh=sbvh,
    )
    return scene.to(dev), info


def _reference_scene(spec, layout, accel, inst_v, all_v, all_n, all_uv, ids, bvh_opts,
                     lights, dev):
    """The reference route's scene (`use_pallas=False`; module
    docstring): the triangle pool and the walked structures, with
    global triangle ids; the build statistics as the kernels' route
    reports them."""
    tris = make_triangle_pool(all_v, all_n, all_uv, ids["obj_id"], ids["mat_id"], device="cpu")
    blas_stats = []
    if accel == "bvh":
        if layout == "mono":
            h, idx, build_stats = bvh_builder.build_bvh(all_v, **bvh_opts)
            host = tree_tables(h, idx)
        else:
            host, build_stats, blas_stats = _build_unified_tlas(inst_v, **bvh_opts)
        structs = [bvh_arrays(host, build_stats, "cpu")]
        num_nodes, depth = structs[0].num_nodes, build_stats.max_depth
    else:
        builder = grid_builder if accel == "grid" else kdtree_builder
        ids_key = "cell_tris" if accel == "grid" else "tri_ids"
        structs, tri_base = [], 0
        for v in [all_v] if layout == "mono" else inst_v:
            host, st = (builder.build_grid if accel == "grid" else builder.build_kdtree)(v)
            host[ids_key] = host[ids_key] + tri_base
            structs.append(builder.to_device(host, "cpu"))
            blas_stats.append(st)
            tri_base += v.shape[0]
        num_nodes = sum(int(s.cell_start.shape[0] - 1 if accel == "grid" else s.num_nodes)
                        for s in structs)
        depth = max(st.max_depth for st in blas_stats)
        # mono: the one structure's build; tlas: no BVH over the instances
        build_stats = blas_stats.pop() if layout == "mono" else bvh_builder.BuildStats()
    v0 = all_v[:, 0]
    scene = DeviceScene(packed=None, pool=np.concatenate([v0, all_v[:, 1] - v0, all_v[:, 2] - v0],
                                                         axis=1),
                        reference=ReferenceTables(tris, accel, structs), **lights)
    info = SceneInfo(name=spec.name, triangle_count=int(all_v.shape[0]),
                     object_count=len(spec.objects), num_nodes=num_nodes, tree_depth=depth,
                     build_stats=build_stats, blas_stats=blas_stats,
                     builder=bvh_opts["builder"], sbvh=bvh_opts["sbvh"])
    return scene.to(dev), info


def instance_matrices(obj) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The object's full TRS matrix, its inverse and the normal matrix
    (the inverse-transpose of the linear part), float32: the shared
    instancing's O(1) SetTransform (blas_bvh.cpp:363-374; the JAX
    package's scene/build.py:465-474)."""
    m = (_object_matrix(obj) @ vm.mat_scale(tuple(obj.scale))).astype(np.float32)
    minv = np.linalg.inv(m).astype(np.float32)
    nrm = np.linalg.inv(m[:3, :3]).T.astype(np.float32)
    return m, minv, nrm


def transform_aabb(bmin, bmax, m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The world box of a box moved by `m`, over its 8 corners, as
    BLASBVH::SetTransform (blas_bvh.cpp:363-374; the JAX package's
    `_transform_aabb`, scene/build.py:56-69)."""
    corners = np.array([[bmin[0] if not i & 1 else bmax[0], bmin[1] if not i & 2 else bmax[1],
                         bmin[2] if not i & 4 else bmax[2]] for i in range(8)], np.float32)
    world = corners @ m[:3, :3].T + m[:3, 3]
    return world.min(axis=0), world.max(axis=0)


def instance_tables(spec, inst_mesh, mesh_bounds) -> dict:
    """The transform tables of `SharedInstances` for the objects of `spec`:
    inverse TRS, normal matrix and world box per instance."""
    n = len(spec.objects)
    out = dict(inst_minv=np.zeros((n, 4, 4), np.float32), inst_nrm=np.zeros((n, 3, 3), np.float32),
               inst_aabb_min=np.zeros((n, 3), np.float32),
               inst_aabb_max=np.zeros((n, 3), np.float32))
    for i, obj in enumerate(spec.objects):
        m, out["inst_minv"][i], out["inst_nrm"][i] = instance_matrices(obj)
        bmin, bmax = mesh_bounds[inst_mesh[i]]
        out["inst_aabb_min"][i], out["inst_aabb_max"][i] = transform_aabb(
            np.asarray(bmin, np.float32), np.asarray(bmax, np.float32), m)
    return out


def _build_shared_instances(spec, bvh_opts: dict, reference: bool = False):
    """One object-space BVH per unique mesh (by model path, in order of
    first use) and the instance tables, as the JAX package's
    `_build_shared_instances` (scene/build.py:477-598), each BVH built
    with `bvh_opts` (`bvh_builder.build_bvh`'s options).  The pool holds
    each unique mesh once; each mesh's tables carry pool-global triangle
    ids in their meta words, and a placeholder object (the mesh's index)
    and material 0 that the query replaces by the instance's.  With
    `reference` each mesh gets its reference `BVHArrays` instead of
    kernel tables, and the pool a `TrianglePool` (`ReferenceTables`).
    Returns (pool [N, 9], SharedInstances, ReferenceTables or None,
    SceneInfo counting every instance's triangles)."""
    mesh_of = {}
    inst_mesh = [mesh_of.setdefault(obj.model_location, len(mesh_of)) for obj in spec.objects]
    meshes = [load_obj(resolve_asset(loc, spec.xml_dir)).triangles() for loc in mesh_of]
    all_v = np.concatenate([v for v, _, _ in meshes]).astype(np.float32)
    all_n = np.concatenate([n for _, n, _ in meshes]).astype(np.float32)
    all_uv = np.concatenate([uv for _, _, uv in meshes]).astype(np.float32)
    shade16 = shading_records(all_v, all_n, all_uv)
    pool_obj = np.concatenate([np.full(v.shape[0], s, np.int32) for s, (v, _, _) in enumerate(meshes)])
    pool_mat = np.zeros(all_v.shape[0], np.int32)
    packs, stats, bounds, tri_base = [], [], [], 0
    for v, _, _ in meshes:
        host, idx, st = bvh_builder.build_bvh(v.astype(np.float32), **bvh_opts)
        if reference:
            packs.append(bvh_arrays(tree_tables(host, idx + tri_base), st, "cpu"))
        else:
            packs.append(pack.pack_bvh(
                host.node_min, host.node_max, host.left, host.right, host.axis, host.left_first,
                host.tri_count, idx + tri_base, all_v, shade16, pool_obj, pool_mat, root=0))
        stats.append(st)
        bounds.append((tuple(float(x) for x in host.node_min[0]),
                       tuple(float(x) for x in host.node_max[0])))
        tri_base += v.shape[0]
    shared = SharedInstances(
        packs, **instance_tables(spec, inst_mesh, bounds),
        inst_obj=2 + np.arange(len(spec.objects), dtype=np.int32),
        inst_mat=np.array([2 + obj.material_idx for obj in spec.objects], np.int32),
        inst_mesh=inst_mesh, mesh_bounds=bounds)
    v0 = all_v[:, 0]
    ref = None
    if reference:
        ref = ReferenceTables(make_triangle_pool(all_v, all_n, all_uv, pool_obj, pool_mat,
                                                 device="cpu"), "bvh", [])
    info = SceneInfo(
        name=spec.name,
        triangle_count=sum(meshes[s][0].shape[0] for s in inst_mesh),
        object_count=len(spec.objects),
        num_nodes=sum(p.num_nodes if reference else p.nodes.shape[0] for p in packs),
        tree_depth=max(st.max_depth if reference else p.depth for p, st in zip(packs, stats)),
        build_stats=stats[0],
        blas_stats=stats[1:],
        builder=bvh_opts["builder"],
        sbvh=bvh_opts["sbvh"],
    )
    return np.concatenate([v0, all_v[:, 1] - v0, all_v[:, 2] - v0], axis=1), shared, ref, info


def _instances(spec, layout: str = "tlas", parity: bool = False):
    """Per instance: world-space vertices [N, 3, 3], normals, uvs, object
    ids and material ids.  `tlas`: the scale baked into the object's
    vertices and then its rigid transform applied; `mono`: the full T @ S
    (module docstring)."""
    mesh_cache = {}
    inst_v, inst_n, inst_uv, inst_obj, inst_mat = [], [], [], [], []
    for i, obj in enumerate(spec.objects):
        path = resolve_asset(obj.model_location, spec.xml_dir)
        if path not in mesh_cache:
            mesh_cache[path] = load_obj(path)
        v, n, uv = mesh_cache[path].triangles()
        t = _object_matrix(obj)
        if layout == "mono":
            full = t @ vm.mat_scale(tuple(obj.scale))
            wv = v @ full[:3, :3].T + full[:3, 3]
            rot = full[:3, :3].T if parity else np.linalg.inv(full[:3, :3]).T
            wn = n @ rot.T
            wn = wn / np.maximum(np.linalg.norm(wn, axis=-1, keepdims=True), 1e-20)
        else:
            wv = (v * obj.scale[None, None, :]) @ t[:3, :3].T + t[:3, 3]
            # normals: object normals rotated by T, unscaled, as the
            # reference (blas_bvh.cpp:391-398)
            wn = n @ t[:3, :3].T
        inst_v.append(wv.astype(np.float32))
        inst_n.append(wn.astype(np.float32))
        inst_uv.append(uv.astype(np.float32))
        inst_obj.append(np.full((v.shape[0],), 2 + i, np.int32))
        inst_mat.append(np.full((v.shape[0],), 2 + obj.material_idx, np.int32))
    return inst_v, inst_n, inst_uv, inst_obj, inst_mat


def tlas_node_tables(xml_path: str) -> tuple[np.ndarray, np.ndarray]:
    """The fused TLAS forest of `accel="bvh"` (the default build) as node
    tables: boxes float32 [6, M] (min xyz, max xyz) and per-octant
    hit/miss links int32 [8, 2, M], threaded from the TLAS root.  The JAX package's
    `pk.node_aabb` and `pk.node_links` (accel/pack.py:169-175,
    scene/build.py:672 there), which its node-step probe reads."""
    host = _build_unified_tlas(_instances(load_scene_xml(xml_path))[0])[0]
    hit, miss = bvh_builder.thread_links(host["left"], host["right"], host["tri_count"],
                                         host["axis"], roots=[host["root"]])
    aabb = np.concatenate([host["node_min"].T, host["node_max"].T], axis=0)
    return (np.ascontiguousarray(aabb, dtype=np.float32),
            np.ascontiguousarray(np.stack([hit, miss], axis=1), dtype=np.int32))


def _build_cell_forest(accel: str, inst_v, all_v, shade16, ids: dict):
    """A grid or KD tree per instance over its world-baked triangles, with
    global triangle ids, compiled to cell trees within the node budget and
    merged into one forest (the JAX package's scene/build.py:281-333).
    Returns the packed forest and each tree's BuildStats."""
    # the JAX package's node cap for the merged forest (a TPU SMEM budget
    # there), kept so that both packages compile the same forest
    budget = max(8192 // len(inst_v), 512)
    trees, stats, tri_base = [], [], 0
    if accel == "kdtree":
        # one table of triangle bounds for clipping leaf bounds, by global id
        tri_bounds = np.stack([all_v.min(axis=1), all_v.max(axis=1)], axis=1)
    for v in inst_v:
        if accel == "grid":
            host, st = grid_builder.build_grid(v)
            host["cell_tris"] = host["cell_tris"] + tri_base
            trees.append(cell_tree.tree_from_grid(host, max_nodes=budget))
        else:
            host, st = kdtree_builder.build_kdtree(v)
            host["tri_ids"] = host["tri_ids"] + tri_base
            host["tri_bounds"] = tri_bounds
            trees.append(cell_tree.tree_from_kd(host, max_nodes=budget))
        stats.append(st)
        tri_base += v.shape[0]
    tree, roots = cell_tree.merge_trees(trees) if len(trees) > 1 else (trees[0], None)
    return cell_tree.pack_tree(tree, all_v, shade16, roots=roots, **ids), stats


def _build_unified_tlas(inst_v: list[np.ndarray], force_split_cap=bvh_builder.FORCE_SPLIT_CAP,
                        leaf_target=bvh_builder.LEAF_TARGET, builder: str = "native",
                        sbvh: bool = False):
    """Per-instance world-space BVHs (`bvh_builder.build_bvh` with these
    options) + agglomerative TLAS, fused into one node forest: [TLAS
    interior][BLAS 0 nodes][BLAS 1 nodes]...  A leaf's first reference is
    offset by the references before its BLAS (an SBVH holds more than its
    triangles), its triangle ids by the triangles.  Returns the host
    arrays `pack.pack_bvh` takes, the forest's BuildStats and each BLAS's
    (scene/build.py:690-702 there)."""
    blas_hosts, blas_idx, blas_stats, inst_bounds = [], [], [], []
    tri_base = 0
    for v in inst_v:
        host, idx, st = bvh_builder.build_bvh(v, force_split_cap, leaf_target, builder=builder,
                                              sbvh=sbvh)
        blas_stats.append(st)
        blas_hosts.append(host)
        blas_idx.append(idx + tri_base)
        inst_bounds.append((host.node_min[0].copy(), host.node_max[0].copy()))
        tri_base += v.shape[0]

    tlas = tlas_builder.build_tlas(
        np.stack([b[0] for b in inst_bounds]), np.stack([b[1] for b in inst_bounds])
    )
    n_top = tlas.node_min.shape[0]  # interior TLAS nodes
    blas_node_base = []
    base = n_top
    for host in blas_hosts:
        blas_node_base.append(base)
        base += host.nodes_used
    total_nodes = base

    node_min = np.zeros((total_nodes, 3), np.float32)
    node_max = np.zeros((total_nodes, 3), np.float32)
    left_first = np.zeros(total_nodes, np.int32)
    tri_count = np.zeros(total_nodes, np.int32)
    left = np.full(total_nodes, -1, np.int32)
    right = np.full(total_nodes, -1, np.int32)
    axis = np.zeros(total_nodes, np.int32)

    def map_child(c: int) -> int:
        # TLAS children < n_top are interior; the rest are instance leaves,
        # which become the instance's BLAS root node
        return c if c < n_top else blas_node_base[c - n_top]

    if n_top:
        node_min[:n_top] = tlas.node_min
        node_max[:n_top] = tlas.node_max
        left[:n_top] = [map_child(int(c)) for c in tlas.left]
        right[:n_top] = [map_child(int(c)) for c in tlas.right]
        axis[:n_top] = tlas.axis

    tri_idx_offset = 0
    for host, nb, idx in zip(blas_hosts, blas_node_base, blas_idx):
        sl = slice(nb, nb + host.nodes_used)
        node_min[sl] = host.node_min
        node_max[sl] = host.node_max
        tri_count[sl] = host.tri_count
        leaf = host.tri_count > 0
        left_first[sl] = np.where(leaf, host.left_first + tri_idx_offset, 0)
        left[sl] = np.where(~leaf, host.left + nb, -1)
        right[sl] = np.where(~leaf, host.right + nb, -1)
        axis[sl] = host.axis
        tri_idx_offset += idx.shape[0]

    host = dict(
        node_min=node_min, node_max=node_max, left=left, right=right, axis=axis,
        left_first=left_first, tri_count=tri_count,
        tri_indices=np.concatenate(blas_idx, axis=0), root=map_child(tlas.root),
    )
    stats = bvh_builder.BuildStats(
        build_time_us=0,
        max_depth=1 + int(np.ceil(np.log2(max(len(inst_v), 2))))
        + max(st.max_depth for st in blas_stats),
        num_nodes=total_nodes,
        num_leaves=int((tri_count > 0).sum()),
        max_leaf=max(st.max_leaf for st in blas_stats),
    )
    return host, stats, blas_stats
