"""Scenes at the limits of the walk records, made from a seed: the inputs
on which the card run (`chip_smoke.py`), the card tests and the parity
tests hold the port's kernels past the widths the main path's scene
reaches (`bunny_teapot.xml`: 10,952 triangles, depth 15, leaves of at most
24 triangles, object ids below 64).

* `caterpillar(levels)`: a binary BVH built by hand, `levels` spine nodes
  deep.  Spine node i has the next spine node as its left child (split
  axis z) and a small interior subtree of two one-triangle leaves as its
  right; every box is the whole scene's.  A ray towards +z visits every
  node, and the stack walk pushes a far child at each spine level: more
  than 64 entries at 100 levels, a tree too deep for the stack
  (`accel/pack.STACK_CAP`, 128) at 140, which the pack threads with links.
* `big_leaf_bvh()`: a root over a leaf of 600 coincident triangles and a
  leaf of one: a count past the 9 bits the walk records once gave it.
  The BVH builder splits any leaf above 24 triangles at the median, so
  this tree too is built by hand.
* `cubes_xml(directory)`: 70 instances of `assets/cube.obj` in a wall:
  object ids up to 71, past the meta word's 6 bits (`accel/pack.py`
  slot_ids); `big_leaf_xml(directory)`: the 600 coincident triangles as an
  OBJ, for the grid and KD tree, which put them all in one cell.
* `scene_over(base, host, shade16, obj_id, mat_id, wide)`: a DeviceScene
  over a hand-built BVH with the materials, atlas, light and floor of
  `base`, collapsed into 8-wide nodes with `wide`;
  `shared_scene_over(base, host, spec)`: a shared-instancing DeviceScene
  whose one mesh is a hand-built BVH, instanced at the objects of `spec`.

The host arrays are those `accel/pack.pack_bvh` takes (`node_min`,
`node_max`, `left`, `right`, `axis`, `left_first`, `tri_count`,
`tri_indices`, `root`) with the triangles `tri_v` [N, 3, 3].
"""

from __future__ import annotations

import os

import numpy as np

from cpu_ray_tracer_tpu_torch.accel import pack
from cpu_ray_tracer_tpu_torch.accel import wide as wide_mod
from cpu_ray_tracer_tpu_torch.core.materials import MaterialTable
from cpu_ray_tracer_tpu_torch.core.textures import Atlas
from cpu_ray_tracer_tpu_torch.scene.build import instance_tables
from cpu_ray_tracer_tpu_torch.scene.types import DeviceScene, SharedInstances

N_CUBES = 70
BIG_LEAF = 600
# the big leaf's triangle and its place, off the planes through the
# default camera's axis that a cell boundary could fall on
BIG_TRI = np.array([[-0.6, -0.5, 0.0], [0.6, -0.5, 0.0], [0.0, 0.6, 0.0]], np.float32)
BIG_OFFSET = (0.0137, 0.0213, 2.0)


def caterpillar(levels: int, seed: int = 0) -> dict:
    """Host arrays of the caterpillar (module docstring): spine nodes
    0 .. L-1, side subtree i at L + 3i with leaves L + 3i + 1 and + 2, the
    spine's end leaf at 4L; one random triangle per leaf in front of the
    default camera (`core/camera.make_camera`); depth L + 2."""
    m = 4 * levels + 1
    left, right = np.full(m, -1, np.int32), np.full(m, -1, np.int32)
    axis = np.zeros(m, np.int32)
    for i in range(levels):
        side = levels + 3 * i
        left[i] = i + 1 if i + 1 < levels else m - 1
        right[i] = side
        axis[i] = 2
        left[side], right[side] = side + 1, side + 2
    leaves = np.nonzero(left < 0)[0]
    tri_count = np.zeros(m, np.int32)
    tri_count[leaves] = 1
    left_first = np.zeros(m, np.int32)
    left_first[leaves] = np.arange(leaves.size)
    rng = np.random.default_rng(seed)
    v0 = rng.uniform([-1.0, -0.8, 1.0], [1.0, 1.0, 3.0], size=(leaves.size, 3))
    tri_v = np.stack([v0, v0 + rng.uniform(-0.5, 0.5, size=(leaves.size, 3)),
                      v0 + rng.uniform(-0.5, 0.5, size=(leaves.size, 3))], axis=1)
    tri_v = tri_v.astype(np.float32)
    lo, hi = tri_v.min(axis=(0, 1)) - 0.05, tri_v.max(axis=(0, 1)) + 0.05
    return dict(
        node_min=np.tile(lo, (m, 1)).astype(np.float32),
        node_max=np.tile(hi, (m, 1)).astype(np.float32),
        left=left, right=right, axis=axis, left_first=left_first, tri_count=tri_count,
        tri_indices=np.arange(leaves.size, dtype=np.int32), tri_v=tri_v, root=0,
    )


def big_leaf_bvh() -> dict:
    """Root 0 over leaf 1 (BIG_LEAF coincident triangles) and leaf 2 (one
    triangle to the side), every box its contents'."""
    big = np.repeat((BIG_TRI + np.array(BIG_OFFSET, np.float32))[None], BIG_LEAF, axis=0)
    side = (BIG_TRI * 0.3 + np.array([0.9, 0.3, 2.5], np.float32))[None]
    tri_v = np.concatenate([big, side]).astype(np.float32)
    lo = np.stack([tri_v.min(axis=(0, 1)), big.min(axis=(0, 1)), side.min(axis=(0, 1))])
    hi = np.stack([tri_v.max(axis=(0, 1)), big.max(axis=(0, 1)), side.max(axis=(0, 1))])
    return dict(
        node_min=lo, node_max=hi, left=np.array([1, -1, -1], np.int32),
        right=np.array([2, -1, -1], np.int32), axis=np.zeros(3, np.int32),
        left_first=np.array([0, 0, BIG_LEAF], np.int32),
        tri_count=np.array([0, BIG_LEAF, 1], np.int32),
        tri_indices=np.arange(BIG_LEAF + 1, dtype=np.int32), root=0, tri_v=tri_v,
    )


def flat_shading(tri_v: np.ndarray, mat: int = 2) -> np.ndarray:
    """Shading records [N, 16]: each triangle's geometric normal at its
    three vertices, uv 0, and material `mat` in lane 15 (the first XML
    material is 2)."""
    n = np.cross(tri_v[:, 1] - tri_v[:, 0], tri_v[:, 2] - tri_v[:, 0])
    n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
    shade = np.zeros((tri_v.shape[0], 16), np.float32)
    shade[:, 0:9] = np.tile(n, 3)
    shade[:, 15] = mat
    return shade


def scene_over(base: DeviceScene, host: dict, shade16=None, obj_id=None,
               mat_id=None, wide: bool = False) -> DeviceScene:
    """A DeviceScene (on the CPU) over the hand-built BVH `host`, with the
    materials, atlas, light and floor of `base`; by default every triangle
    is object 2 with material 2, flat-shaded.  `wide` collapses the tree
    into 8-wide nodes as `compile_scene(wide=True)` does (walk "wide")."""
    tri_v = host["tri_v"]
    n = tri_v.shape[0]
    obj_id = np.full(n, 2, np.int32) if obj_id is None else obj_id
    mat_id = np.full(n, 2, np.int32) if mat_id is None else mat_id
    shade16 = flat_shading(tri_v) if shade16 is None else shade16
    packed = pack.pack_bvh(
        host["node_min"], host["node_max"], host["left"], host["right"], host["axis"],
        host["left_first"], host["tri_count"], host["tri_indices"], tri_v, shade16,
        obj_id, mat_id, root=int(host["root"]),
    )
    wide_pack = None
    if wide:
        wide_pack = wide_mod.pack_wide(
            host["node_min"], host["node_max"], host["left"], host["right"], host["tri_count"],
            int(host["root"]), packed.nodes[:, pack.N_FIRST], packed.nodes[:, pack.N_COUNT],
            packed.leaf_codes)
    return DeviceScene(packed=packed, pool=_pool(tri_v), wide=wide_pack, **_base_fields(base))


def shared_scene_over(base, host: dict, spec) -> DeviceScene:
    """A shared-instancing DeviceScene (on the CPU) of one mesh, the
    hand-built BVH `host` in object space, instanced at the objects of
    `spec` (`io/scene_xml.SceneSpec`: each object's transform; object ids
    2 + i, material 2), with the materials, atlas, light and floor of
    `base`.  A mesh deeper than STACK_CAP takes the link walk."""
    tri_v = host["tri_v"]
    n = tri_v.shape[0]
    mesh = pack.pack_bvh(
        host["node_min"], host["node_max"], host["left"], host["right"], host["axis"],
        host["left_first"], host["tri_count"], host["tri_indices"], tri_v,
        flat_shading(tri_v, mat=0), np.zeros(n, np.int32), np.zeros(n, np.int32),
        root=int(host["root"]))
    bounds = [(tuple(float(x) for x in host["node_min"][host["root"]]),
               tuple(float(x) for x in host["node_max"][host["root"]]))]
    inst_mesh = (0,) * len(spec.objects)
    shared = SharedInstances(
        [mesh], **instance_tables(spec, inst_mesh, bounds),
        inst_obj=2 + np.arange(len(spec.objects), dtype=np.int32),
        inst_mat=np.full(len(spec.objects), 2, np.int32), inst_mesh=inst_mesh,
        mesh_bounds=bounds)
    return DeviceScene(packed=None, pool=_pool(tri_v), shared=shared, **_base_fields(base))


def _pool(tri_v: np.ndarray) -> np.ndarray:
    v0 = tri_v[:, 0]
    return np.concatenate([v0, tri_v[:, 1] - v0, tri_v[:, 2] - v0], axis=1)


def _base_fields(base: DeviceScene) -> dict:
    """The materials, atlas, light and floor arguments of a DeviceScene, as
    `base` holds them."""

    def np_(name):
        return getattr(base, name).cpu().numpy()

    return dict(
        materials=MaterialTable(
            albedo=np_("mat_albedo"), reflectivity=np_("mat_reflectivity"),
            refractivity=np_("mat_refractivity"), absorption=np_("mat_absorption"),
            tex_id=np_("mat_tex_id"), is_light=np_("mat_is_light")),
        atlas=Atlas(texels=np_("atlas_texels"), packed=np_("atlas_packed"),
                    offset=np_("atlas_offset"), width=np_("atlas_width"),
                    height=np_("atlas_height")),
        light_t=np_("light_t"), light_inv_t=np_("light_inv_t"),
        light_size=float(base.light_size), light_color=np_("light_color"),
        floor_inv_to=float(base.floor_inv_to), skydome_tex=base.skydome_tex,
        shadow_quirk=base.shadow_quirk,
    )


def _xyz(tag, x, y, z) -> str:
    return f"<{tag}><x>{x}</x><y>{y}</y><z>{z}</z></{tag}>"


def write_scene_xml(directory: str, name: str, assets: str, objects,
                    materials=((0.0, 0.0),)) -> str:
    """Write a scene XML into `directory` and return its path: `objects`
    (obj path, material index, position, scale) and `materials`
    (reflectivity, refractivity), the floor texture and skydome from
    `assets`, the light at (0, 2, 1)."""
    objs = "".join(
        f"<object><model_location>{path}</model_location><material_idx>{mat}</material_idx>"
        + _xyz("position", *pos) + _xyz("rotation", 0, 0, 0) + _xyz("scale", *scale)
        + "</object>"
        for path, mat, pos, scale in objects
    )
    mats = "".join(
        f"<material><reflectivity>{refl}</reflectivity><refractivity>{refr}</refractivity>"
        + _xyz("absorption", 0, 0, 0) + "<texture_location></texture_location></material>"
        for refl, refr in materials
    )
    xml = os.path.join(directory, f"{name}.xml")
    with open(xml, "w") as f:
        f.write(
            f"<scene><scene_name>{name}</scene_name>" + _xyz("light_position", 0, 2, 1)
            + f"<plane_texture_location>{assets}/textures/log_fence.png</plane_texture_location>"
            + f"<skydome_location>{assets}/industrial_sunset_puresky_4k.png</skydome_location>"
            + f"<objects>{objs}</objects><materials>{mats}</materials></scene>"
        )
    return xml


def cubes_xml(directory: str, assets: str) -> str:
    """N_CUBES small cubes (`assets/cube.obj`) in a 10 x 7 wall in front of
    the default camera, diffuse and mirror in turns."""
    cube = os.path.join(assets, "cube.obj")
    objects = [(cube, i % 2, (-0.9 + 0.2 * (i % 10), -0.6 + 0.2 * (i // 10), 2.0 + 0.05 * (i % 3)),
                (0.08, 0.08, 0.08)) for i in range(N_CUBES)]
    return write_scene_xml(directory, "cubes70", assets, objects,
                           materials=((0.0, 0.0), (0.8, 0.0)))


def big_leaf_xml(directory: str, assets: str) -> str:
    """BIG_LEAF coincident triangles (an OBJ written beside the XML), a
    mirror, at BIG_OFFSET."""
    obj = os.path.join(directory, "stack.obj")
    with open(obj, "w") as f:
        f.write("".join(f"v {x} {y} {z}\n" for x, y, z in BIG_TRI))
        f.write("vt 0 0\nvt 1 0\nvt 0.5 1\nvn 0 0 -1\n")
        f.write("f 1/1/1 2/2/1 3/3/1\n" * BIG_LEAF)
    return write_scene_xml(directory, "big_leaf", assets, [(obj, 0, BIG_OFFSET, (1, 1, 1))],
                           materials=((0.5, 0.0),))
