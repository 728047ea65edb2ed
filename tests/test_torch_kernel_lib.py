"""The kernel library's build key (`ops/kernel_lib.library_path`): every
file under `csrc/` counts, the shared headers included, so an edited header
can never load a library built from the old one.  No nvcc is needed."""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from cpu_ray_tracer_tpu_torch.accel import pack
from cpu_ray_tracer_tpu_torch.ops import (
    kernel_lib, link_walk, surface, wavefront_pt, whitted_wf, wide_bvh,
)
from cpu_ray_tracer_tpu_torch.ops.closest_hit import occluded
from cpu_ray_tracer_tpu_torch.scene import query
from cpu_ray_tracer_tpu_torch.scene.build import compile_scene

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                      "scenes")


@pytest.fixture()
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(kernel_lib.CSRC, copy)
    monkeypatch.setattr(kernel_lib, "CSRC", str(copy))
    return copy


def test_sources_include_the_shared_headers():
    names = sorted(os.listdir(kernel_lib.CSRC))
    assert {"ptraverse.cuh", "surface.cuh", "closest_hit.cu", "link_walk.cu", "wide_bvh.cu",
            "wavefront_pt.cu", "whitted_wf.cu"} <= set(names)
    for name in names:
        if name.endswith(".cu"):
            with open(os.path.join(kernel_lib.CSRC, name)) as f:
                assert '#include "' in f.read(), name


@pytest.mark.parametrize("name", ["ptraverse.cuh", "surface.cuh", "wavefront_pt.cu"])
def test_an_edited_file_changes_the_library_path(csrc, name):
    before = kernel_lib.library_path()
    assert kernel_lib.library_path() == before  # stable while nothing changes
    path = csrc / name
    path.write_text(path.read_text() + "\n// edited\n")
    after = kernel_lib.library_path()
    assert after != before
    assert os.path.dirname(after) == kernel_lib.BUILD_DIR


def test_a_renamed_file_changes_the_library_path(csrc):
    before = kernel_lib.library_path()
    (csrc / "surface.cuh").rename(csrc / "surface2.cuh")
    assert kernel_lib.library_path() != before


def test_every_entry_point_has_a_signature():
    """Each `extern "C"` function of the sources is bound with its argument
    count (a pointer passed as a 32-bit int would be cut)."""
    for name, argtypes in kernel_lib._SIGNATURES.items():
        found = None
        for src in os.listdir(kernel_lib.CSRC):
            with open(os.path.join(kernel_lib.CSRC, src)) as f:
                m = re.search(rf"\bint {name}\(([^)]*)\)", f.read())
            if m:
                found = m.group(1)
        assert found is not None, name
        assert len(found.split(",")) == len(argtypes), name


def _constants(header: str) -> dict:
    with open(os.path.join(kernel_lib.CSRC, header)) as f:
        return {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", f.read())}


def test_kernel_params_follow_the_header_layout():
    """The scene's `kernel_params`, packed once by `surface.kernel_params`,
    against the P_* offsets and the MAT_F record of csrc/surface.cuh."""
    c = _constants("surface.cuh")
    assert c["MAX_MATS"] == surface.MAX_MATS
    scene, _ = compile_scene(os.path.join(SCENES, "bunny_teapot.xml"), device="cpu")
    p = surface.params(scene)
    assert p is scene.kernel_params
    # bit-cast integer fields are NaN patterns (tex_id -1): compare bits
    assert torch.equal(p.view(torch.int32), surface.kernel_params(scene).view(torch.int32))
    n = scene.material_count
    assert p.shape == (c["P_MATS"] + n * c["MAT_F"],) and p.dtype == torch.float32
    assert torch.equal(p[c["P_LIGHT_INV_T"]:c["P_LIGHT_INV_T"] + 16], scene.light_inv_t.reshape(16))
    assert torch.equal(p[c["P_LIGHT_N"]:c["P_LIGHT_N"] + 3], -scene.light_t[:3, 1])
    assert p[c["P_LIGHT_SIZE"]] == scene.light_size and p[c["P_FLOOR_INV_TO"]] == scene.floor_inv_to
    assert torch.equal(p[c["P_LIGHT_POS"]:c["P_LIGHT_POS"] + 3], query.get_light_pos(scene))
    assert p[c["P_INV2PI_W"]] == surface.INV2PI_W and p[c["P_TWO_PI"]] == np.float32(2 * np.pi)
    mats = p[c["P_MATS"]:].reshape(n, c["MAT_F"])
    ints = mats.view(torch.int32)
    assert torch.equal(mats[:, 0:3], scene.mat_albedo)
    assert torch.equal(mats[:, 3], scene.mat_reflectivity)
    assert torch.equal(mats[:, 4], scene.mat_refractivity)
    assert torch.equal(mats[:, 5:8], scene.mat_absorption)
    assert torch.equal(ints[:, 8], scene.mat_is_light.to(torch.int32))
    for col, field in ((9, "tex_id"), (10, "tex_off"), (11, "tex_w"), (12, "tex_h")):
        assert torch.equal(ints[:, col], getattr(scene, f"mat_{field}")), field
    assert (ints[:, 9] >= 0).any()  # the textured floor


def test_wrappers_reject_other_devices():
    xml = os.path.join(SCENES, "cube_scene.xml")
    scene, _ = compile_scene(xml, device="cpu")
    grid, _ = compile_scene(xml, accel="grid", device="cpu")
    wide, _ = compile_scene(xml, wide=True, device="cpu")
    o = torch.zeros((4, 3), device="meta")
    t = torch.zeros(4, device="meta")
    seeds = torch.zeros(4, dtype=torch.int64, device="meta")
    for call in (
        lambda: occluded(scene, o, o, t),
        lambda: wavefront_pt.trace(scene, o, o, seeds, 1, 5),
        lambda: whitted_wf.trace_level0(scene, o, o),
        lambda: link_walk.closest_hit_links(grid, o, o, t),
        lambda: link_walk.occluded_links(grid, o, o, t),
        lambda: wide_bvh.closest_hit_wide(wide, o, o, t),
        lambda: wide_bvh.occluded_wide(wide, o, o, t),
    ):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


def test_walk_records_follow_the_header_layout():
    """The walk records' sizes and the stack capacity (accel/pack.py)
    against the constants csrc/ptraverse.cuh reads them with."""
    c = _constants("ptraverse.cuh")
    assert c["STACK_CAP"] == pack.STACK_CAP and c["LEAF_SHIFT"] == pack.LEAF_SHIFT
    assert 4 * c["RECORD_INT4"] == pack.RECORD_WORDS
    assert 4 * c["LINK_RECORD_INT4"] == pack.LINK_RECORD_WORDS
    scene, _ = compile_scene(os.path.join(SCENES, "cube_scene.xml"), device="cpu")
    assert 4 * c["TRI_FLOAT4"] == scene.tris4.shape[1]


def test_vector_loads_need_aligned_tables():
    """The walks load 16-byte records: a table view at an offset is refused."""
    records = torch.zeros((4, 16), dtype=torch.int32)
    kernel_lib.require_aligned("walk", node_records=records)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernel_lib.require_aligned("walk", node_records=records.view(-1)[1:])
