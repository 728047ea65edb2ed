"""The share of the traced window of train steps in which no kernel ran on the device."""

LAYER = "Device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "grad_step_ms"


def read(obs):
    return 100.0 * (1.0 - obs.trace.busy_s / obs.trace.window_s)
