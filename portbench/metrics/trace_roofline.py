"""Share of the walk kernels' roofline: the least time the card could take for the rays
traced, over the kernels' device time."""

LAYER = "Walk kernels (ops/wavefront_pt, ops/closest_hit, ops/whitted_wf, ops/link_walk, on csrc/*.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "rays_per_s"

# the kernels that trace rays, by the names they launch under: closest hit
# (K1), the link walk (K2), the wavefront kernel (K3), the Whitted level
# kernel (K4)
KERNELS = ("closest_hit_kernel", "closest_hit_links_kernel", "wavefront_kernel", "whitted_kernel")


def read(obs):
    """The bound of the trace work over the device time of KERNELS: each
    traced ray's origin and direction read once and its hit written once,
    and the scene's triangles read once a depth, at the card's memory rate.
    It counts the work, not the nodes or tests of the walk that does it."""
    from portbench.lib.harness import RAY_BYTES, TRI_BYTES
    from portbench.lib.peaks import roofline

    device_s = obs.trace.device_s(KERNELS)
    if device_s <= 0:
        return None
    moved = obs.rays * RAY_BYTES + obs.levels * obs.triangles * TRI_BYTES
    return 100.0 * roofline(moved, 0.0)["bound_ms"] / 1e3 / device_s
