"""The path tracer's gradients against the JAX package's (as
`test_torch_diff_pt.py`) on `bunny_teapot` at 64x40 with the `bench.py`
camera, nearest mode: smooth normals interpolated by the recomputed
barycentrics, so vertex gradients flow through the shading frame."""

import pytest

from test_torch_diff_pt import case_grads, check_case
from torch_grads import KEYS


@pytest.fixture(scope="module")
def pt_grads():
    return case_grads("bunny_teapot-nearest")


@pytest.mark.parametrize("key", KEYS)
def test_path_tracer_grads_match_jax_on_bunny_teapot(pt_grads, key):
    check_case(pt_grads, key)
