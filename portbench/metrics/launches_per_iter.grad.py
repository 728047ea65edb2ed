"""Kernel launches per train step over the traced window (the profiler's count of device
kernels)."""

LAYER = "Gradients (diff/optimize.make_train_step, diff/grad, the differentiable route of render/pathtracer)"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "grad_step_ms"


def read(obs):
    return obs.trace.launches / obs.iterations
