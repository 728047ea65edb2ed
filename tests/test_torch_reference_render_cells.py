"""The renders of `test_torch_reference_render.py` on the grid forest of
the TLAS layout (one grid per instance, chained by `ops/forest.py`): the
path tracer, Whitted and the counter AOVs against the JAX package's
`use_pallas=False` scene, under the same rules.  The KD forest is
`test_torch_reference_render_kd.py`."""

import pytest

from test_torch_reference_render import (  # noqa: F401  (the tests run here on these scenes)
    reference_scenes, test_counter_aovs_match_jax, test_path_tracer_matches_jax,
    test_whitted_matches_jax,
)

CASES = {"tlas-grid": dict(layout="tlas", accel="grid")}


@pytest.fixture(scope="module", params=list(CASES))
def scenes(request):
    return reference_scenes(request.param, CASES[request.param])
