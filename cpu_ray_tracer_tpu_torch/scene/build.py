"""Host-side scene compiler: XML spec -> DeviceScene.

The port of the JAX package's `cpu_ray_tracer_tpu/scene/build.py` for the
configuration the path tracer's main path uses: `layout="tlas"`,
`accel="bvh"`, `instancing="baked"` — the reference's TLASFileScene
(infra/scene/tlas_file_scene.cpp) with every instance baked into world
space and all BLAS nodes fused under the TLAS into one node forest
(`_build_unified_tlas`, scene/build.py:601-702 there).  Node numbering,
builds and the leaf triangle order are the JAX package's, so the two
packages' tables compare one to one.
"""

from __future__ import annotations

import numpy as np

from cpu_ray_tracer_tpu_torch import constants
from cpu_ray_tracer_tpu_torch.accel import bvh_builder, pack, tlas_builder
from cpu_ray_tracer_tpu_torch.core import vecmath as vm
from cpu_ray_tracer_tpu_torch.core.materials import make_table
from cpu_ray_tracer_tpu_torch.core.textures import build_atlas
from cpu_ray_tracer_tpu_torch.io.image import load_texture_image
from cpu_ray_tracer_tpu_torch.io.obj import load_obj
from cpu_ray_tracer_tpu_torch.io.scene_xml import load_scene_xml, resolve_asset
from cpu_ray_tracer_tpu_torch.scene.types import DeviceScene, SceneInfo

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
    xml_path: str, layout: str = "tlas", accel: str = "bvh", instancing: str = "baked",
    shadow_quirk: bool = True,
) -> tuple[DeviceScene, SceneInfo]:
    """Compile an XML scene to a DeviceScene on the CPU; `.to(device)`
    moves it.  `shadow_quirk` as the JAX package's (`DeviceScene` doc)."""
    if layout != "tlas":
        raise NotImplementedError("layout='mono' is not ported yet (ROADMAP queue 1, item 10)")
    if accel != "bvh":
        raise NotImplementedError(f"accel={accel!r} is not ported yet (ROADMAP queue 1, item 12)")
    if instancing != "baked":
        raise NotImplementedError("instancing='shared' is not ported yet (ROADMAP queue 1, item 13)")
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

    # ---- geometry: scale baked into object vertices, then the rigid T ---
    mesh_cache = {}
    inst_v, inst_n, inst_uv, inst_obj, inst_mat = [], [], [], [], []
    for i, obj in enumerate(spec.objects):
        path = resolve_asset(obj.model_location, xml_dir)
        if path not in mesh_cache:
            mesh_cache[path] = load_obj(path)
        v, n, uv = mesh_cache[path].triangles()
        t = _object_matrix(obj)
        wv = (v * obj.scale[None, None, :]) @ t[:3, :3].T + t[:3, 3]
        # normals: object normals rotated by T, unscaled, as the reference
        # (blas_bvh.cpp:391-398)
        wn = n @ t[:3, :3].T
        inst_v.append(wv.astype(np.float32))
        inst_n.append(wn.astype(np.float32))
        inst_uv.append(uv.astype(np.float32))
        inst_obj.append(np.full((v.shape[0],), 2 + i, np.int32))
        inst_mat.append(np.full((v.shape[0],), 2 + obj.material_idx, np.int32))
    all_v = np.concatenate(inst_v, axis=0)
    all_n = np.concatenate(inst_n, axis=0)
    all_uv = np.concatenate(inst_uv, axis=0)

    # shading records: degenerate vertex normals filled with geometric ones
    v0 = all_v[:, 0]
    e1 = all_v[:, 1] - v0
    e2 = all_v[:, 2] - v0
    gn = np.cross(e1, e2)
    gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
    bad = np.linalg.norm(all_n, axis=-1) < 1e-8
    all_n = np.where(bad[..., None], gn[:, None, :], all_n)
    shade16 = np.zeros((all_v.shape[0], 16), np.float32)
    shade16[:, 0:9] = all_n.reshape(-1, 9)
    shade16[:, 9:15] = all_uv.reshape(-1, 6)

    host = _build_unified_tlas(inst_v)
    packed = pack.pack_bvh(
        **host, tri_v=all_v, shade16=shade16,
        obj_id=np.concatenate(inst_obj), mat_id=np.concatenate(inst_mat),
    )

    light_t = vm.mat_translate(tuple(spec.light_pos))
    scene = DeviceScene(
        packed=packed,
        pool=np.concatenate([v0, e1, e2], axis=1),
        materials=materials,
        atlas=atlas,
        light_t=light_t,
        light_inv_t=vm.mat_inverted_no_scale(light_t),
        light_size=LIGHT_SIZE,
        light_color=constants.LIGHT_COLOR,
        floor_inv_to=100.0 / floor_tex_width,
        skydome_tex=skydome_tex,
        shadow_quirk=shadow_quirk,
    )
    info = SceneInfo(
        name=spec.name,
        triangle_count=int(all_v.shape[0]),
        object_count=len(spec.objects),
        num_nodes=int(packed.nodes.shape[0]),
        tree_depth=packed.depth,
    )
    return scene, info


def _build_unified_tlas(inst_v: list[np.ndarray]) -> dict:
    """Per-instance world-space BVHs + agglomerative TLAS, fused into one
    node forest: [TLAS interior][BLAS 0 nodes][BLAS 1 nodes]...  Returns the
    host arrays `pack.pack_bvh` takes."""
    blas_hosts, blas_idx, inst_bounds = [], [], []
    tri_base = 0
    for v in inst_v:
        host, idx = bvh_builder.build_bvh(v)
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

    return dict(
        node_min=node_min, node_max=node_max, left=left, right=right, axis=axis,
        left_first=left_first, tri_count=tri_count,
        tri_indices=np.concatenate(blas_idx, axis=0), root=map_child(tlas.root),
    )
