"""Seconds of `compile_scene`, from the XML to the scene on the device, by the host clock with
the device synchronized after it."""

LAYER = "Scene build (scene/build, accel/*, io/*)"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(obs):
    return obs.build_s
