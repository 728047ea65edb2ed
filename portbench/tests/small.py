"""The cells at a size the CPU holds: 64x40, 4 samples a pixel, short
orbits; the limits stay the committed ones."""

from portbench.lib import harness

SMALL = dict(width=64, height=40, spp=4, check_pixels=256, orbit_frames=8, check_first_frames=4,
             trace_units=1)
SEED = 2**31 + 12345
# every cell the CPU tests drive: those of BENCHMARK.json and the parked ones
CELLS = [w["name"] for w in harness.benchmark()["workloads"]] + harness.parked_cells()


def cell(name: str):
    c = harness.load_cell(name)
    c.params.update(SMALL)
    return c


def run(name: str, trace: bool = False):
    """One run of the small cell on the CPU: (result, set-up's split)."""
    return harness.execute(cell(name), SEED, 0.1, trace, "cpu")
