"""Host-side I/O of the PyTorch port against the JAX package and PIL: the
PNG decoder (stdlib zlib + numpy), the Radiance .hdr reader, OBJ and scene
XML parsing."""

import glob
import os
import struct

import numpy as np
import pytest
from PIL import Image

from conftest import OUR_ASSETS
from cpu_ray_tracer_tpu.io import image as jax_image
from cpu_ray_tracer_tpu.io import obj as jax_obj
from cpu_ray_tracer_tpu.io import scene_xml as jax_xml
from cpu_ray_tracer_tpu_torch.io import image, obj, scene_xml

PNGS = sorted(glob.glob(os.path.join(OUR_ASSETS, "**", "*.png"), recursive=True))
OBJS = sorted(glob.glob(os.path.join(OUR_ASSETS, "*.obj")))
XMLS = sorted(glob.glob(os.path.join(OUR_ASSETS, "scenes", "*.xml")))


@pytest.mark.parametrize("path", PNGS, ids=os.path.basename)
def test_png_decode_equals_pil(path):
    want = np.asarray(Image.open(path))
    got = image.decode_png(path)
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    np.testing.assert_array_equal(
        image.load_texture_image(path), jax_image.load_texture_image(path)
    )


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_modes_and_filters(tmp_path, mode):
    """Every colour type the decoder takes, on a noisy image with smooth
    parts, so that PIL's encoder picks several scanline filters."""
    rng = np.random.default_rng(3)
    h, w = 37, 53
    ramp = (np.arange(h)[:, None] * 3 + np.arange(w)[None, :] * 5) % 256
    chans = len(mode)
    arr = np.stack([(ramp + 40 * c) % 256 for c in range(chans)], axis=-1).astype(np.uint8)
    arr[::3] = rng.integers(0, 256, size=arr[::3].shape, dtype=np.uint8)
    path = str(tmp_path / f"t_{mode}.png")
    Image.fromarray(arr.squeeze(-1) if chans == 1 else arr, mode).save(path, optimize=True)
    want = np.asarray(Image.open(path))
    np.testing.assert_array_equal(image.decode_png(path).reshape(want.shape), want)
    np.testing.assert_array_equal(
        image.load_texture_image(path), jax_image.load_texture_image(path)
    )


def _write_hdr(path, rgbe: np.ndarray, rle: bool):
    h, w, _ = rgbe.shape
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        for y in range(h):
            if not rle:
                f.write(rgbe[y].tobytes())
                continue
            f.write(struct.pack(">BBH", 2, 2, w))
            for c in range(4):
                row = rgbe[y, :, c]
                x = 0
                while x < w:  # one run of the first byte, then literals
                    if x == 0:
                        f.write(bytes([128 + 3, row[0]]))
                        x = 3
                    n = min(128, w - x)
                    f.write(bytes([n]) + row[x : x + n].tobytes())
                    x += n


@pytest.mark.parametrize("rle", [False, True])
def test_hdr_reader_equals_jax(tmp_path, rle):
    rng = np.random.default_rng(5)
    rgbe = rng.integers(0, 256, size=(6, 20, 4), dtype=np.uint8)
    rgbe[:, :3] = rgbe[:, :1]  # the RLE writer's leading run of 3
    rgbe[0, 0, 3] = 0  # a zero exponent is black
    path = str(tmp_path / "sky.hdr")
    _write_hdr(path, rgbe, rle)
    np.testing.assert_array_equal(
        image._load_radiance_hdr(path), jax_image._load_radiance_hdr(path)
    )
    np.testing.assert_array_equal(
        image.load_texture_image(path), jax_image.load_texture_image(path)
    )


def _assert_mesh_equal(a, b):
    for field in ("positions", "normals", "uvs", "indices"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)


@pytest.mark.parametrize("path", OBJS, ids=os.path.basename)
def test_obj_equals_jax(path):
    _assert_mesh_equal(obj.load_obj(path), jax_obj.load_obj(path))


def test_obj_polygons_and_indices_equal_jax(tmp_path):
    """Fan triangulation of a quad and a pentagon, negative indices, and
    corners without normal or uv (zeros), deduplicated on the full triple."""
    path = tmp_path / "poly.obj"
    path.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 1.5 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvn 0 0 1\n"
        "f 1/1/1 2/2/1 3/3/1 4//1\n"
        "f -5 -4 -3 -2 -1\n"
        "f 1/1 3/3 5\n"
    )
    got = obj.load_obj(str(path))
    _assert_mesh_equal(got, jax_obj.load_obj(str(path)))
    assert got.num_tris == 2 + 3 + 1


@pytest.mark.parametrize("path", XMLS, ids=os.path.basename)
def test_scene_xml_equals_jax(path):
    a, b = scene_xml.load_scene_xml(path), jax_xml.load_scene_xml(path)
    for field in ("name", "plane_texture_location", "skydome_location", "xml_dir"):
        assert getattr(a, field) == getattr(b, field)
    np.testing.assert_array_equal(a.light_pos, b.light_pos)
    assert len(a.objects) == len(b.objects) and len(a.materials) == len(b.materials)
    for oa, ob in zip(a.objects, b.objects):
        assert (oa.model_location, oa.material_idx) == (ob.model_location, ob.material_idx)
        for f in ("position", "rotation", "scale"):
            np.testing.assert_array_equal(getattr(oa, f), getattr(ob, f))
    for ma, mb in zip(a.materials, b.materials):
        assert (ma.reflectivity, ma.refractivity, ma.texture_location) == (
            mb.reflectivity, mb.refractivity, mb.texture_location,
        )
        np.testing.assert_array_equal(ma.absorption, mb.absorption)
    refs = [a.plane_texture_location, a.skydome_location] + [o.model_location for o in a.objects]
    for ref in refs:
        assert scene_xml.resolve_asset(ref, a.xml_dir) == jax_xml.resolve_asset(ref, a.xml_dir)
