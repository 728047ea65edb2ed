"""Host syncs per iteration: the `aten::nonzero` and `aten::_local_scalar_dense` calls of
one untimed unit of iterations, counted as they dispatch."""

LAYER = "Render loop and host glue (render/progressive, render/pathtracer, render/whitted, scene/query, render/common)"
UNIT = "syncs"
SOURCE = "program_counter"
MOVES = "rays_per_s"


def read(obs):
    return obs.syncs_per_iteration
