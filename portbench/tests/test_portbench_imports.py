"""What a run may load: no JAX, and not the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's); the
reference loads nothing of the port."""

import os
import subprocess
import sys

from portbench.lib import harness

CODE = """
import sys
sys.path.insert(0, {repo!r})
{imports}
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def _top_level(imports: str) -> list:
    out = subprocess.run([sys.executable, "-c", CODE.format(repo=harness.REPO, imports=imports)],
                         capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    return eval(out.stdout.strip().splitlines()[-1])


def test_harness_and_reference_load_no_jax():
    names = _top_level("import portbench.run, portbench.calibrate\n"
                       "from portbench.lib import faults, harness, traffic, profile\n"
                       "from portbench.reference import render, scene, trace\n"
                       "for e in ('progressive', 'whitted_frames', 'train_step'):\n"
                       "    traffic.entry_module(e)\n"
                       "import cpu_ray_tracer_tpu_torch.render.progressive\n"
                       "import cpu_ray_tracer_tpu_torch.render.whitted\n"
                       "import cpu_ray_tracer_tpu_torch.diff.optimize\n"
                       "import cpu_ray_tracer_tpu_torch.scene.build")
    assert "cpu_ray_tracer_tpu_torch" in names
    assert not set(names) & set(harness.BANNED), names


def test_reference_loads_nothing_of_the_port():
    names = _top_level("from portbench.reference import render, scene, trace")
    assert "cpu_ray_tracer_tpu_torch" not in names and not set(names) & set(harness.BANNED)


def test_banned_names_are_compared_whole():
    sys.modules.setdefault("cpu_ray_tracer_tpu_torch_x", sys)
    try:
        found = harness.banned_modules()
        assert "cpu_ray_tracer_tpu_torch_x" not in found and "cpu_ray_tracer_tpu" not in found
    finally:
        del sys.modules["cpu_ray_tracer_tpu_torch_x"]
