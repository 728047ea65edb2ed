"""Kernel launches per iteration over the traced window (the profiler's count of device
kernels)."""

LAYER = "Render loop and host glue (render/progressive, render/pathtracer, render/whitted, scene/query, render/common)"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "rays_per_s"


def read(obs):
    return obs.trace.launches / obs.iterations
