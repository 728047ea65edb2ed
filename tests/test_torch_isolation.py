"""The PyTorch port imports neither JAX, optax, flax, PIL nor the JAX
package: the machine with the card has none of them."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "cpu_ray_tracer_tpu_torch"
BLOCKED = ("jax", "jaxlib", "optax", "flax", "PIL", "cpu_ray_tracer_tpu")
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)

_IMPORT_ALL = f"""
import importlib, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of them raises ImportError
for name in {MODULES!r}:
    importlib.import_module(name)
loaded = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r} and sys.modules[m] is not None]
assert not loaded, loaded
print(len({MODULES!r}))
"""


def test_every_module_imports_without_jax_flax_pil():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(MODULES) >= 20


@pytest.mark.parametrize(
    "path",
    sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_blocked_import_statement(path):
    """Also the imports inside functions, which an import run misses."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BLOCKED, f"{path.name}: import {name}"


@pytest.mark.parametrize(
    "path", sorted((PKG / "ops").glob("*.py")), ids=lambda p: str(p.relative_to(REPO)),
)
def test_kernel_layer_imports_no_layer_above(path):
    """`ops/` (the kernels, their wrappers and plain versions) imports
    nothing of `scene/` or `render/`, which are built on it."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
        elif isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        else:
            continue
        for name in names:
            for above in ("scene", "render"):
                assert not name.startswith(f"{PKG.name}.{above}"), f"{path.name}: import {name}"


def test_every_kernel_module_is_covered():
    """The wrappers, plain versions and renderers of every ported kernel
    are among the modules imported above."""
    for name in ("ops.closest_hit", "ops.link_walk", "ops.wide_bvh", "ops.wavefront_pt",
                 "ops.whitted_wf", "ops.surface", "ops.kernel_lib", "accel.cell_tree",
                 "accel.grid_builder", "accel.kdtree_builder", "accel.wide",
                 "render.pathtracer", "render.whitted", "ops.leaf_probe", "ops.sync_probe",
                 "benchmarks.mxu_probe", "benchmarks.sync_probe", "benchmarks.leaf_tolerance",
                 "diff.grad", "diff.optimize", "render.basics", "render.progressive", "cli",
                 "scene.animate", "scene.primitive_scene", "ops.primitives", "core.noise",
                 "ops.traverse_bvh", "ops.traverse_grid", "ops.traverse_kd", "ops.forest",
                 "accel.types", "accel.compile", "accel.native", "parallel.mesh",
                 "parallel.sharded"):
        assert f"cpu_ray_tracer_tpu_torch.{name}" in MODULES, name
