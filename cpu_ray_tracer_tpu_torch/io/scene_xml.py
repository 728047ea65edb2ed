"""XML scene-file parser, same schema and asset resolution as the JAX
package's `cpu_ray_tracer_tpu/io/scene_xml.py`, without its upstream
asset root.

Schema (README.md:56-117, parsed by tlas_file_scene.cpp:95-166):

    <scene>
      <scene_name>...</scene_name>
      <light_position><x/><y/><z/></light_position>
      <plane_texture_location>...</plane_texture_location>
      <skydome_location>...</skydome_location>
      <objects><object>
          <model_location/><material_idx/>
          <position><x/><y/><z/></position>
          <rotation><x/><y/><z/></rotation>   (degrees)
          <scale><x/><y/><z/></scale>
      </object>...</objects>
      <materials><material>
          <reflectivity/><refractivity/>
          <absorption><x/><y/><z/></absorption>
          <texture_location/>
      </material>...</materials>
    </scene>

Paths inside the XML are relative to a project directory *next to* the assets
tree (the reference binaries run from e.g. `3. PathTracer/`, so
`../assets/...` lands in the repo's `assets/`).  `resolve_asset` reproduces
that: `../X` resolves against the parent of the directory holding the XML's
assets tree, with a substitution fallback into this repo's own `assets/` for
files the upstream repo references but does not ship.
"""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET

import numpy as np

_REPO_ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "assets")

# Files referenced by the upstream scene XMLs but absent from the checked-out
# repo (SURVEY.md §2 "Missing assets").  We ship substitutes.
_SUBSTITUTE_EXTS = (".png", ".jpg", ".jpeg", ".tga", ".obj")


@dataclasses.dataclass
class ObjectSpec:
    model_location: str
    material_idx: int
    position: np.ndarray  # [3]
    rotation: np.ndarray  # [3] degrees
    scale: np.ndarray  # [3]


@dataclasses.dataclass
class MaterialSpec:
    reflectivity: float
    refractivity: float
    absorption: np.ndarray  # [3]
    texture_location: str  # "" = none


@dataclasses.dataclass
class SceneSpec:
    name: str
    light_pos: np.ndarray  # [3]
    plane_texture_location: str
    skydome_location: str
    objects: list[ObjectSpec]
    materials: list[MaterialSpec]
    xml_dir: str  # directory containing the XML (for path resolution)


def _xyz(node) -> np.ndarray:
    out = np.zeros(3, np.float32)
    for child in node:
        idx = ord(child.tag[0]) - ord("x")  # x/y/z -> 0/1/2, as the reference
        out[idx] = float(child.text)
    return out


def load_scene_xml(path: str) -> SceneSpec:
    tree = ET.parse(path)
    root = tree.getroot()
    objects = []
    for obj in root.find("objects").findall("object"):
        objects.append(
            ObjectSpec(
                model_location=obj.find("model_location").text.strip(),
                material_idx=int(obj.find("material_idx").text),
                position=_xyz(obj.find("position")),
                rotation=_xyz(obj.find("rotation")),
                scale=_xyz(obj.find("scale")),
            )
        )
    materials = []
    for mat in root.find("materials").findall("material"):
        tex = mat.find("texture_location")
        materials.append(
            MaterialSpec(
                reflectivity=float(mat.find("reflectivity").text),
                refractivity=float(mat.find("refractivity").text),
                absorption=_xyz(mat.find("absorption")),
                texture_location=(tex.text or "").strip() if tex is not None else "",
            )
        )
    return SceneSpec(
        name=root.find("scene_name").text,
        light_pos=_xyz(root.find("light_position")),
        plane_texture_location=root.find("plane_texture_location").text.strip(),
        skydome_location=root.find("skydome_location").text.strip(),
        objects=objects,
        materials=materials,
        xml_dir=os.path.dirname(os.path.abspath(path)),
    )


def resolve_asset(spec_path: str, xml_dir: str) -> str:
    """Resolve an XML-relative asset path to an existing file.

    Resolution order:
      1. `../X` against the grandparent of the XML dir (reproducing the
         reference's run-from-project-dir behavior: `assets/scenes/../..` is
         the tree containing `assets/`);
      2. as given, relative to the XML dir;
      3. substitution: same relative path under this repo's own assets/;
      4. substitution: same basename with any known extension under this
         repo's assets/ (covers the upstream's missing .hdr skydome, which we
         ship as a .png).
    """
    rel = spec_path.replace("\\", "/")
    candidates = []
    if rel.startswith("../"):
        tree_root = os.path.dirname(os.path.dirname(xml_dir))
        candidates.append(os.path.normpath(os.path.join(tree_root, rel[3:])))
    candidates.append(os.path.normpath(os.path.join(xml_dir, rel)))
    sub_rel = rel[3:] if rel.startswith("../") else rel
    if sub_rel.startswith("assets/"):
        sub_rel = sub_rel[len("assets/") :]
    candidates.append(os.path.join(_REPO_ASSETS, sub_rel))
    base, _ = os.path.splitext(sub_rel)
    for ext in _SUBSTITUTE_EXTS:
        candidates.append(os.path.join(_REPO_ASSETS, base + ext))

    for c in candidates:
        if os.path.isfile(c):
            return c
    raise FileNotFoundError(
        f"asset '{spec_path}' not found; tried: {candidates}"
    )
