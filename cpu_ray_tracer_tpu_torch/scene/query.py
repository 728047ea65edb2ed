"""Scene queries over ray batches, as the JAX package's
`cpu_ray_tracer_tpu/scene/query.py`: FindNearest and its differentiable
form, IsOccluded, GetHitInfo, the material fields, GetAlbedo, the sky and
GetLightPos (the reference's BaseScene virtuals,
infra/scene/base_scene.h:16-32).  The triangle queries go to the kernel
of the scene's walk (`DeviceScene.walk`): the binary stack walk, the link
walk of the grid and KD cell forests, or the wide walk; on a
shared-instancing scene ("instanced") one masked pass of the stack walk
(or of the link walk, for a mesh deeper than its stack) per instance, in
the instance's object space (`_instanced`, scene/query.py:24-87 there).
A scene of the reference route (`use_pallas=False`) takes the reference
walks instead (`DeviceScene.reference`), with the JAX package's XLA
semantics: the walk takes no mask (masked-off rays are walked and
counted, their hits reported), and a shared scene's pass of an instance
starts the rays it leaves out at t0 = -1, where they still take a counted
step (scene/query.py:64-70, :106-139 there).  A hit's `slot` is its
triangle id there.
The kernels take detached rays: visibility carries no gradient, and
`find_nearest_diff` recomputes the winner's t and barycentrics with
autograd.  The reference's analytic primitive scene
(`scene/primitive_scene.py`, a `PrimScene`) answers every query with its
own closed forms.
"""

from __future__ import annotations

import numpy as np
import torch

from cpu_ray_tracer_tpu_torch import constants
from cpu_ray_tracer_tpu_torch.core import textures as tex_mod
from cpu_ray_tracer_tpu_torch.core import vecmath as vm
from cpu_ray_tracer_tpu_torch.ops import intersect, traverse_bvh
from cpu_ray_tracer_tpu_torch.ops.closest_hit import closest_hit, occluded
from cpu_ray_tracer_tpu_torch.ops.link_walk import closest_hit_links, occluded_links
from cpu_ray_tracer_tpu_torch.ops.wide_bvh import closest_hit_wide, occluded_wide
from cpu_ray_tracer_tpu_torch.scene import primitive_scene as prim
from cpu_ray_tracer_tpu_torch.scene.primitive_scene import PrimScene

_TINY_D = np.float32(1e-30)


def wide_perm(scene, perm):
    """`perm` where the scene's walk takes a lane order (the wide walk),
    else None: the binary and link walks take rays in order."""
    return perm if scene.walk == "wide" else None


def triangle_hit(scene, o, d, t0, mask=None, perm=None) -> dict:
    """Closest triangle hit (`ops/closest_hit.py`'s dict) by the scene's
    walk (the JAX package's `_traverse_accel`, scene/query.py:90-139); the
    wide walk's lanes take the rays in the order `perm` where given (the
    other walks refuse one)."""
    if scene.walk == "wide":
        return closest_hit_wide(scene, o, d, t0, mask, perm)
    _no_perm(scene, perm)
    if scene.walk == "instanced":
        return _instanced(scene, o, d, t0, mask, any_hit=False)
    if scene.walk == "reference":
        res = scene.reference.walk(o, d, t0, any_hit=False)
        return dict(res, slot=res["tri_idx"])
    if scene.walk == "links":
        return closest_hit_links(scene, o, d, t0, mask)
    return closest_hit(scene, o, d, t0, mask)


def triangle_occluded(scene, o, d, t0, mask=None, perm=None) -> torch.Tensor:
    """Any triangle hit in (TRI_EPS, t0), bool [R], by the scene's walk,
    in the lane order `perm` as `triangle_hit`."""
    if scene.walk == "wide":
        return occluded_wide(scene, o, d, t0, mask, perm)
    _no_perm(scene, perm)
    if scene.walk == "instanced":
        return _instanced(scene, o, d, t0, mask, any_hit=True)
    if scene.walk == "reference":
        return scene.reference.walk(o, d, t0, any_hit=True)["tri_idx"] >= 0
    if scene.walk == "links":
        return occluded_links(scene, o, d, t0, mask)
    return occluded(scene, o, d, t0, mask)


def _instance_of(scene, obj: torch.Tensor) -> torch.Tensor:
    """The instance index of object ids `obj` (2 + i), clamped into the
    table (a miss or a primitive takes instance 0; its row is masked)."""
    return (obj - 2).clamp(0, scene.shared.inst_minv.shape[0] - 1).long()


def _affine(x: torch.Tensor, m: torch.Tensor, translate: bool) -> torch.Tensor:
    """Rows of `m` [.., 4, 4] (one matrix, or one a ray) applied to x [R, 3],
    with m's translation where `translate`: elementwise products in the
    order of `x @ m[:3, :3].T + m[:3, 3]`, so that the card and the CPU
    round alike (no matrix product, whose float32 order a library picks)."""
    cols = []
    for j in range(3):
        row = m[..., j, :]
        c = x[:, 0] * row[..., 0] + x[:, 1] * row[..., 1] + x[:, 2] * row[..., 2]
        cols.append(c + row[..., 3] if translate else c)
    return torch.stack(cols, dim=1)


def _instanced(scene, o, d, t0, mask, any_hit: bool):
    """Shared-BLAS traversal (the JAX package's `_traverse_instanced`,
    scene/query.py:24-87; the reference's BLASBVH::Intersect,
    blas_bvh.cpp:376-389): for each instance, the rays moved into its
    object space by its inverse TRS (directions not renormalised, so t is
    one scalar in both spaces), the rays whose interval through its world
    box cannot beat the running best t masked off, one walk of its mesh's
    tables from that best t.  Closest hit: the walks' dict with the hit's
    object and material from the instance table and its slot in the
    scene's `shade`; any hit: bool [R], the instances ORed, each pass
    skipping the rays already occluded.  On the reference route a pass
    walks every ray, those it leaves out from t0 = -1 (module
    docstring)."""
    sh = scene.shared
    r, dev = o.shape[0], o.device
    live_in = torch.ones(r, dtype=torch.bool, device=dev) if mask is None else mask
    rd = 1.0 / torch.where(d.abs() < _TINY_D, _TINY_D, d)
    occ = torch.zeros(r, dtype=torch.bool, device=dev)
    if not any_hit:
        out = dict(t=t0, u=torch.zeros_like(t0), v=torch.zeros_like(t0))
        for key in ("slot", "tri_idx", "obj_id", "mat_id"):
            out[key] = torch.full((r,), -1, dtype=torch.int32, device=dev)
        for key in ("traversed", "tested"):
            out[key] = torch.zeros(r, dtype=torch.int32, device=dev)
    for i, m in enumerate(sh.inst_mesh):
        mesh, minv = sh.meshes[m], sh.inst_minv[i]
        o_i = _affine(o, minv, True)
        d_i = _affine(d, minv, False)
        # the world-box early-out against the running best t (the TLAS's role)
        t1 = (sh.inst_aabb_min[i] - o) * rd
        t2 = (sh.inst_aabb_max[i] - o) * rd
        tn = torch.amax(torch.minimum(t1, t2), dim=-1)
        tf = torch.amin(torch.maximum(t1, t2), dim=-1)
        live = live_in & (tf >= tn) & (tf > 0.0)
        # a ray not occluded yet still has t0 as its best t
        best = t0 if any_hit else out["t"]
        live = live & (tn < best) & ~occ
        if scene.reference is not None:
            res = traverse_bvh.traverse(mesh, scene.reference.tris, o_i, d_i,
                                        torch.where(live, best, np.float32(-1.0)), any_hit)
            res["slot"] = res["tri_idx"]
            if any_hit:
                occ = occ | (res["tri_idx"] >= 0)
                continue
        elif any_hit:
            occ = occ | triangle_occluded(mesh, o_i, d_i, t0, live)
            continue
        else:
            res = triangle_hit(mesh, o_i, d_i, best, live)
        hit = res["slot"] >= 0
        hit_ids = dict(slot=res["slot"] + sh.slot_base[m], tri_idx=res["tri_idx"],
                       obj_id=sh.inst_obj[i].expand(r), mat_id=sh.inst_mat[i].expand(r))
        for key in ("t", "u", "v", *hit_ids):
            out[key] = torch.where(hit, hit_ids.get(key, res.get(key)), out[key])
        out["traversed"] = out["traversed"] + res["traversed"]
        out["tested"] = out["tested"] + res["tested"]
    return occ if any_hit else out


def _no_perm(scene, perm) -> None:
    if perm is not None:
        raise ValueError(f"a lane order for the {scene.walk!r} walk, which takes rays in order")


def find_nearest(scene, o: torch.Tensor, d: torch.Tensor, perm=None) -> dict:
    """Nearest hit over light quad -> floor plane -> triangle BVH, as
    FileScene::FindNearest (file_scene.cpp:170-175).  Object ids: 0 light,
    1 floor, >= 2 mesh instances, -1 miss.  `perm`: the wide walk's lane
    order (`triangle_hit`).  A `PrimScene` answers with its objects' ids
    (`primitive_scene.find_nearest`)."""
    if isinstance(scene, PrimScene):
        return prim.find_nearest(scene, o, d)
    t, obj = intersect.primitive_hits(scene, o, d)
    res = triangle_hit(scene, o, d, t, perm=perm)
    tri_hit = res["tri_idx"] >= 0
    return dict(
        t=res["t"],
        obj_idx=torch.where(tri_hit, res["obj_id"], obj),
        tri_idx=res["tri_idx"],
        slot=res["slot"],
        u=res["u"],
        v=res["v"],
        mat_id_tri=res["mat_id"],
        traversed=res["traversed"],
        tested=res["tested"],
    )


def find_nearest_diff(scene, o: torch.Tensor, d: torch.Tensor, perm=None) -> dict:
    """`find_nearest` with t and the barycentrics differentiable (the JAX
    package's `find_nearest_diff`, scene/query.py:188-262): the walk runs
    on detached rays and picks the hit, then the winner's t, u, v are
    recomputed with autograd from the triangle pool `scene.pool` (Moller-
    Trumbore against v0, e1, e2), the floor plane and the light quad, so
    gradients reach the rays and the vertices (detached visibility: no
    silhouette gradients).  The walk records stay as built: a vertex step
    does not refit the tree.  On a shared-instancing scene the pool is in
    object space, and the solve takes the rays through the winning
    instance's inverse TRS (t is one scalar in both spaces).  A
    `PrimScene`'s closed forms are differentiable as they stand."""
    if isinstance(scene, PrimScene):
        return prim.find_nearest(scene, o, d)
    hit = find_nearest(scene, o.detach(), d.detach(), perm)
    tri = hit["tri_idx"]
    obj = hit["obj_idx"]
    o_mt, d_mt = o, d
    if scene.shared is not None:
        minv = scene.shared.inst_minv[_instance_of(scene, obj)]
        o_mt, d_mt = _affine(o, minv, True), _affine(d, minv, False)
    # index_select: its backward adds rows (atomics), where an index's
    # sorts and serializes the rays that share a triangle
    rows = scene.pool.index_select(0, tri.clamp_min(0).long())
    v0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    h = torch.cross(d_mt, e2, dim=-1)
    a = vm.dot(e1, h)
    f = 1.0 / torch.where(a.abs() < np.float32(1e-20), np.float32(1e-20), a)
    s = o_mt - v0
    u = f * vm.dot(s, h)
    q = torch.cross(s, e1, dim=-1)
    v = f * vm.dot(d_mt, q)
    t_tri = f * vm.dot(e2, q)
    # floor plane y = -1
    dy = torch.where(d[:, 1].abs() < np.float32(1e-20), np.float32(1e-20), d[:, 1])
    t_floor = -(o[:, 1] + intersect.FLOOR_D) / dy
    # light quad: the plane y = 0 of its local frame
    it = scene.light_inv_t
    oy = o[:, 0] * it[1, 0] + o[:, 1] * it[1, 1] + o[:, 2] * it[1, 2] + it[1, 3]
    dyq = d[:, 0] * it[1, 0] + d[:, 1] * it[1, 1] + d[:, 2] * it[1, 2]
    dyq = torch.where(dyq.abs() < np.float32(1e-20), np.float32(1e-20), dyq)
    t_quad = oy / -dyq
    is_tri = tri >= 0
    t = torch.where(is_tri, t_tri,
                    torch.where(obj == 1, t_floor, torch.where(obj == 0, t_quad, hit["t"])))
    return dict(hit, t=t, u=torch.where(is_tri, u, hit["u"]), v=torch.where(is_tri, v, hit["v"]))


def is_occluded(scene, o: torch.Tensor, d: torch.Tensor, dist: torch.Tensor, mask=None,
                perm=None):
    """Shadow query (file_scene.cpp:177-187): the light quad occludes within
    `dist` (the caller passes dist - 2 EPS); triangles occlude within
    RAY_FAR when `scene.shadow_quirk` (the reference's quirk), else within
    `dist`.  The floor never occludes.  `mask` [R] bool limits the triangle
    query, `perm` is the wide walk's lane order; bool [R].  The inputs are
    detached: visibility carries no gradient.  A `PrimScene` takes the
    reference's own shadow query (`primitive_scene.is_occluded`: no
    quirk, no mask; the caller masks)."""
    o, d, dist = o.detach(), d.detach(), dist.detach()
    if isinstance(scene, PrimScene):
        return prim.is_occluded(scene, o, d, dist)
    _, lhit = intersect.quad(o, d, scene.light_inv_t, scene.light_size, dist)
    tri_t = torch.full_like(dist, constants.RAY_FAR) if scene.shadow_quirk else dist
    return lhit | triangle_occluded(scene, o, d, tri_t.contiguous(), mask, perm)


def get_light_pos(scene) -> torch.Tensor:
    """GetLightPos: the point light, float32 [3] (`intersect.light_pos`)."""
    return intersect.light_pos(scene.light_t)


def get_hit_info(scene, hit: dict, point: torch.Tensor, d: torch.Tensor):
    """Normal, uv and material id per ray (tlas_file_scene.cpp:220-260),
    with the back-face flip `if dot(N, D) > 0: N = -N`.  Triangle hits
    interpolate the winning slot's shading record; on a shared-instancing
    scene that normal is in object space, and the winning instance's
    normal matrix takes it to world space (renormalised).  A `PrimScene`
    answers with its objects' normals (`primitive_scene.get_hit_info`)."""
    if isinstance(scene, PrimScene):
        return prim.get_hit_info(scene, hit, point, d)
    obj = hit["obj_idx"]
    tri_hit = (hit["tri_idx"] >= 0)[:, None]
    n_tri, uv_tri = traverse_bvh.interpolate_hit(scene.shade, hit["slot"], hit["u"], hit["v"])
    if scene.shared is not None:
        n_w = _affine(n_tri, scene.shared.inst_nrm[_instance_of(scene, obj)], False)
        n_w = n_w / torch.clamp_min(torch.linalg.vector_norm(n_w, dim=-1, keepdim=True),
                                    np.float32(1e-20))
        n_tri = torch.where(tri_hit, n_w, n_tri)

    # light quad normal: TransformVector((0,-1,0), T) (primitives.h:365-369)
    light_n = -scene.light_t[:3, 1]
    floor_n = torch.as_tensor(intersect.FLOOR_NORMAL, device=point.device)
    floor_uv = intersect.plane_uv(point, scene.floor_inv_to)
    is_light = (obj == 0)[:, None]
    is_floor = (obj == 1)[:, None]
    normal = torch.where(tri_hit, n_tri, torch.where(is_light, light_n, floor_n))
    uv = torch.where(tri_hit, uv_tri, torch.where(is_floor, floor_uv, 0.0))
    mat_id = torch.where(tri_hit[:, 0], hit["mat_id_tri"], torch.where(is_light[:, 0], 0, 1))
    # error material (pink) for misses queried anyway
    mat_id = torch.where(obj < 0, scene.material_count - 1, mat_id)
    flip = ((normal * d).sum(dim=-1) > 0)[:, None]
    return torch.where(flip, -normal, normal), uv, mat_id


def material_fields(scene, mat_id: torch.Tensor) -> dict:
    """Per-ray material fields.  The float fields are the JAX package's
    one-hot matrix product (scene/query.py:366-395 there), whose backward
    is a product too: the backward of an index of ~10 rows by every ray is
    a scatter whose colliding rows serialize (23 ms a field at 921,600
    rays on an H100, PERF.md).  The product runs in float64, so each
    output is one table value times 1, exact whatever the float32 matmul
    precision (TF32 never applies to float64)."""
    m = mat_id.long()
    table = torch.cat((scene.mat_albedo, scene.mat_reflectivity[:, None],
                       scene.mat_refractivity[:, None], scene.mat_absorption), dim=1)
    one_hot = m[:, None] == torch.arange(table.shape[0], device=m.device)
    f = (one_hot.to(torch.float64) @ table.to(torch.float64)).to(torch.float32)
    return dict(
        albedo=f[:, 0:3],
        reflectivity=f[:, 3],
        refractivity=f[:, 4],
        absorption=f[:, 5:8],
        is_light=scene.mat_is_light[m],
        tex_id=scene.mat_tex_id[m],
        tex_off=scene.mat_tex_off[m],
        tex_w=scene.mat_tex_w[m],
        tex_h=scene.mat_tex_h[m],
    )


def get_albedo(scene, fields: dict, uv: torch.Tensor, obj=None, point=None) -> torch.Tensor:
    """Material::GetAlbedo (material.h:28-35): the texture's sample where
    the material has a texture, the constant albedo otherwise.  The tap is
    the nearest texel of the packed atlas, or on a bilinear scene the
    bilinear tap of the float atlas, which carries the texel gradient.  On
    a `PrimScene` the material's albedo, overridden on the walls and the
    floor where the hits' objects `obj` [R] and points `point` [R, 3] are
    given (the reference's isAlbedoOverridden, renderer.cpp:32)."""
    if isinstance(scene, PrimScene):
        if obj is None or point is None:
            return fields["albedo"]
        overridden = ((obj >= 4) & (obj <= 6))[:, None]
        return torch.where(overridden, prim.get_albedo_override(scene, obj, point),
                           fields["albedo"])
    if scene.bilinear:
        tap, atlas = tex_mod.sample_bilinear, scene.atlas_texels
    else:
        tap, atlas = tex_mod.nearest_texel, scene.atlas_packed
    texel = tap(atlas, fields["tex_off"], fields["tex_w"], fields["tex_h"], uv[:, 0], uv[:, 1])
    return torch.where((fields["tex_id"] >= 0)[:, None], texel, fields["albedo"])


def texel_factor(scene, idx: torch.Tensor) -> torch.Tensor:
    """float32 [R, 3]: the atlas texel `idx` [R] (a nearest-texel index the
    wavefront and Whitted kernels record), 1 where idx < 0 (the JAX
    package's `_tex_rgb`, render/pathtracer.py:547)."""
    rgb = tex_mod.unpack_rgb(scene.atlas_packed[idx.clamp_min(0).long()])
    return torch.where((idx >= 0)[:, None], rgb, np.float32(1.0))


def sky_color(scene, d: torch.Tensor) -> torch.Tensor:
    """Equirect skydome sample, or black when the scene has none."""
    if scene.skydome_tex < 0:
        return torch.zeros(d.shape[:-1] + (3,), dtype=torch.float32, device=d.device)
    return tex_mod.sample_equirect(scene, d, scene.bilinear)
