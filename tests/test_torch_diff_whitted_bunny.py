"""Whitted's gradients against the JAX package's (as
`test_torch_diff.py`) on `bunny_teapot` at 64x40 with the `bench.py`
camera, depth 2, nearest and bilinear: its mirror teapot and dielectric
bunny drive the reflectivity, refractivity and absorption gradients,
which the cube scene leaves at 0.  The JAX package's vertex gradients are
NaN for the triangles whose secondary rays miss, so their rows are
compared where finite; in bilinear mode the port's taps replay the JAX
package's tap positions (`test_torch_diff.whitted_case_grads`)."""

import pytest

from test_torch_diff import check_whitted, whitted_case_grads
from torch_grads import KEYS


@pytest.fixture(scope="module", params=["bunny_teapot-nearest", "bunny_teapot-bilinear"])
def whitted_grads(request):
    return whitted_case_grads(request.param)


@pytest.mark.parametrize("key", KEYS)
def test_whitted_grads_match_jax_on_bunny_teapot(whitted_grads, key):
    check_whitted(whitted_grads, key)
