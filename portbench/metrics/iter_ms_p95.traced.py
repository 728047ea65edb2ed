"""The 95th percentile of the traced window's iteration times (host clock, each ending in a
wait for the device), under the profiler: `iter_ms_p95` where its runs spread too widely to
hold it end to end."""

import numpy as np

LAYER = "Render loop and host glue (render/progressive, render/pathtracer, render/whitted, scene/query, render/common)"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "rays_per_s"


def read(obs):
    return float(np.percentile(obs.times_ms, 95))
