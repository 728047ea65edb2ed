"""The traced run's reading of the profiler, on events made by hand."""

from types import SimpleNamespace as NS

from portbench.lib import profile


class Devices:
    CUDA, CPU = "cuda", "cpu"


def _ev(name, start, end, device):
    return NS(name=name, time_range=NS(start=start, end=end), device_type=device)


def test_idle_gaps_skip_range_spans_and_name_the_host_op():
    events = [_ev("k1", 0, 10, "cuda"), _ev("depth_1", 0, 100, "cuda"), _ev("k2", 50, 60, "cuda"),
              _ev("k3", 90, 100, "cuda"), _ev("depth_1", 0, 100, "cpu"),
              _ev("aten::nonzero", 12, 48, "cpu"), _ev("aten::mul", 61, 70, "cpu"),
              _ev("aten::add", 70, 89, "cpu")]
    assert profile.idle_gaps(events, Devices) == [["depth_1/aten::nonzero", 40e-6],
                                                  ["depth_1/aten::add", 30e-6]]


def test_trace_sums():
    tr = profile.Trace(2.0, {"closest_hit_kernel<true>": (0.3, 10), "elementwise": (0.1, 40)}, [])
    assert tr.busy_s == 0.4 and tr.launches == 50
    assert tr.device_s(("closest_hit_kernel",)) == 0.3
    assert tr.top_ops(1) == [["closest_hit_kernel<true>", 0.3]]
