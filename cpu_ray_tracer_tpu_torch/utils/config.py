"""The render configuration as one dataclass with command-line overrides,
as the JAX package's `cpu_ray_tracer_tpu/utils/config.py`: the same
fields, defaults and flag parsing (every field is a flag: `--scene-xml`,
`--cam-pos 0,0.3,-1.2`, booleans as 1/true/yes, `--force-split-cap none`),
plus `device`, the device the port renders on (the card unless the caller
asks for another).

`use_pallas` maps as the JAX package's: "false" builds the reference
walks (`compile_scene(use_pallas=False)`, plain PyTorch on the device),
"true" and "auto" the kernels (their plain versions on the CPU; the JAX
package's "auto" takes the kernels on a TPU only).  `sharded` splits the
path tracer's pixels over the ranks of a ray mesh (`parallel/`, the CLI's
docstring); `n_devices` is then the world size the run expects (0: the
launcher's).  `whitted_cap_factor` and `whitted_grow_cap` are accepted
and change nothing: the port's Whitted tracer gathers children exactly
and drops none.  `passes_per_step` is accepted and unused, as in the JAX
package's CLI.  The BVH builder is the native one, as the JAX package's
default; the JAX CLI reads `CRT_NATIVE` and `CRT_SBVH` from the
environment, and the port's config has no field for them (as none for
`wide`): `compile_scene(builder=..., sbvh=...)` takes them.
"""

from __future__ import annotations

import argparse
import dataclasses

from cpu_ray_tracer_tpu_torch import constants


@dataclasses.dataclass
class RenderConfig:
    # scene
    scene_xml: str = ""
    layout: str = "tlas"  # "tlas" (TLASFileScene) | "mono" (FileScene)
    accel: str = "bvh"  # "bvh" | "grid" | "kdtree"
    instancing: str = "baked"  # "baked" | "shared" (one BVH per unique mesh)
    parity: bool = False  # the reference's normals quirk and BVH stops
    use_pallas: str = "auto"  # "auto" | "true" (the kernels) | "false" (the reference walks)
    shadow_quirk: bool = True
    bilinear: bool = False
    force_split_cap: int | None = 4  # None = reference SAH stopping exactly
    # camera / film
    width: int = constants.SCRWIDTH
    height: int = constants.SCRHEIGHT
    cam_pos: tuple = (0.0, 0.0, -2.0)
    cam_target: tuple = (0.0, 0.0, -1.0)
    # integrator
    integrator: str = "pathtracer"  # "whitted" | "pathtracer" | "basics"
    aov: str = "albedo"  # for basics
    depth_limit: int = constants.DEPTH_LIMIT
    spp: int = 16
    passes_per_step: int = 1
    whitted_cap_factor: float = 0.25
    whitted_grow_cap: bool = True
    # output / observability
    out: str = "out.png"
    checkpoint: str = ""  # path for progressive film checkpoints
    checkpoint_every: int = 0  # passes between checkpoints (0 = off)
    metrics_jsonl: str = ""  # per-step metrics log
    # distribution
    n_devices: int = 0
    sharded: bool = False
    # the device the port renders on
    device: str = "cuda"

    def build_scene(self):
        from cpu_ray_tracer_tpu_torch.scene.build import compile_scene

        return compile_scene(
            self.scene_xml,
            layout=self.layout,
            accel=self.accel,
            instancing=self.instancing,
            parity=self.parity,
            force_split_cap=self.force_split_cap,
            shadow_quirk=self.shadow_quirk,
            bilinear=self.bilinear,
            use_pallas=None if self.use_pallas == "auto" else self.use_pallas == "true",
            device=self.device,
        )

    def build_camera(self):
        from cpu_ray_tracer_tpu_torch.core.camera import make_camera

        return make_camera(self.width, self.height, self.cam_pos, self.cam_target)


def _add_args(parser: argparse.ArgumentParser):
    for f in dataclasses.fields(RenderConfig):
        name = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(f.default, bool):
            parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=f.default)
        elif f.name in ("cam_pos", "cam_target"):
            parser.add_argument(name, type=lambda s: tuple(float(x) for x in s.split(",")),
                                default=f.default)
        elif f.name == "force_split_cap":
            parser.add_argument(name, type=lambda s: None if s == "none" else int(s),
                                default=f.default)
        else:
            parser.add_argument(name, type=type(f.default) if f.default is not None else str,
                                default=f.default)


def parse_args(argv=None) -> RenderConfig:
    parser = argparse.ArgumentParser(description="PyTorch port of the TPU-native ray tracer")
    _add_args(parser)
    ns = parser.parse_args(argv)
    return RenderConfig(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(RenderConfig)})
