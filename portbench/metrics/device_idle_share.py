"""The share of the traced window in which no kernel ran on the device: 1 - busy / wall."""

LAYER = "Device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "rays_per_s"


def read(obs):
    return 100.0 * (1.0 - obs.trace.busy_s / obs.trace.window_s)
