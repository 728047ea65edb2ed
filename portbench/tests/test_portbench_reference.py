"""The reference against the port's CPU route at 64x40, for each mix, and
the result line's shape."""

import json
import subprocess
import sys

import pytest
import torch

from portbench.lib import harness
from portbench.reference import trace
from portbench.reference.scene import load_scene
from portbench.tests import small

def test_product_form_equals_moller_trumbore():
    """The reference's matrix-product form of the triangle test against the
    textbook one, both in float64, on rays aimed at the scene."""
    scene = load_scene(f"{harness.REPO}/assets/scenes/bunny_teapot.xml")
    g = torch.Generator().manual_seed(7)
    o = torch.tensor([0.0, 0.3, -1.2], dtype=torch.float64).expand(4096, 3).contiguous()
    aim = scene.v0[torch.randint(0, scene.v0.shape[0], (4096,), generator=g)]
    d = aim + 0.05 * torch.randn(4096, 3, generator=g, dtype=torch.float64) - o
    d = d / d.norm(dim=-1, keepdim=True)
    t, tri, u, v = trace.triangles(scene, o, d, torch.full((4096,), 1e34, dtype=torch.float64))
    # the textbook test, one ray at a time against every triangle
    for i in range(0, 4096, 97):
        h = torch.cross(d[i].expand_as(scene.e2), scene.e2, dim=-1)
        a = (scene.e1 * h).sum(-1)
        s = o[i] - scene.v0
        uu = (s * h).sum(-1) / a
        q = torch.cross(s, scene.e1, dim=-1)
        vv = (d[i] * q).sum(-1) / a
        tt = (scene.e2 * q).sum(-1) / a
        ok = (a.abs() >= 1e-4) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & (tt > 1e-4)
        if not ok.any():
            assert tri[i] == -1
            continue
        best = torch.where(ok, tt, torch.inf).argmin()
        assert tri[i] == best and torch.isclose(t[i], tt[best], rtol=1e-12)
        assert torch.isclose(u[i], uu[best], atol=1e-9) and torch.isclose(v[i], vv[best], atol=1e-9)
    assert (tri >= 0).sum() > 2000


@pytest.mark.parametrize("name", small.CELLS)
def test_reference_agrees_with_the_port(name):
    result, split = small.run(name)
    assert result["correct"], result["checks"]
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["metrics"]) == {m["name"] for m in small.cell(name).end_to_end}
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert {"start_s", "cuda_s", "build_s", "warm_up_s", "window", "reference_s"} <= set(split)


def test_traced_result_line():
    result, _ = small.run("bvh.whitted", trace=True)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                            "checks"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "build_s" in result["metrics"] and "host_syncs_per_iter" in result["metrics"]
    json.dumps(result)


def test_no_card_no_result():
    out = subprocess.run([sys.executable, f"{harness.PB}/run.py", "--workload", "bvh.pt",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""
