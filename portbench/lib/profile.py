"""What a traced window reads off the profiler, and the operation count of
one untimed iteration.

The device's busy time (the sum of its kernels' device time, on one
stream), the idle share 1 - busy / wall and `count_ops` are copied from
`tools/profile_torch_pass.py` (`_device_us`, `device_kernels`,
`count_ops`), so that no later change of that tool moves them.  The idle
gaps and what the host did in each are this file's own.
"""

from __future__ import annotations

import dataclasses

SYNC_OPS = ("aten::nonzero", "aten::_local_scalar_dense")
RANGES = ("wavefront_", "depth_", "level_")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


@dataclasses.dataclass
class Trace:
    """A profiled window: its wall seconds, each kernel's device seconds and
    launches, and the longest idle gaps."""

    window_s: float
    kernels: dict  # name -> (device seconds, launches)
    idle_gaps: list  # [(what the host did, seconds)], longest first

    @property
    def busy_s(self) -> float:
        return sum(s for s, _ in self.kernels.values())

    @property
    def launches(self) -> int:
        return sum(n for _, n in self.kernels.values())

    def device_s(self, names) -> float:
        """Device seconds of the kernels whose names contain one of `names`."""
        return sum(s for k, (s, _) in self.kernels.items() if any(n in k for n in names))

    def top_ops(self, n: int = 10) -> list:
        return sorted(([k, s] for k, (s, _) in self.kernels.items()), key=lambda x: -x[1])[:n]


def read(prof, window_s: float) -> Trace:
    from torch.autograd import DeviceType

    # the ranges show on the device timeline as spans around their kernels;
    # kernels alone make the busy time
    on_device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels = {e.key: (_device_us(e) / 1e6, e.count) for e in on_device
               if not e.key.startswith(RANGES)}
    return Trace(window_s, kernels, idle_gaps(prof.events(), DeviceType))


def idle_gaps(events, device_type, n: int = 10) -> list:
    """The `n` longest gaps between kernels on the device timeline, each
    named by the host operation that overlaps it most (the enclosing range
    of the program, such as `depth_3`, before it)."""
    kernels, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == device_type.CUDA:
            if not e.name.startswith(RANGES):  # a range's span is no device work
                kernels.append((tr.start, tr.end))
        elif not e.name.startswith(("cuda", "cudaLaunch", "Memcpy", "ProfilerStep")):
            host.append((tr.start, tr.end, e.name))
    kernels.sort()
    gaps, last_end = [], None
    for start, end in kernels:
        if last_end is not None and start > last_end:
            gaps.append((start - last_end, last_end, start))
        last_end = end if last_end is None else max(last_end, end)
    gaps = sorted(gaps, reverse=True)[:n]
    host.sort()
    out = []
    for length, g0, g1 in gaps:
        best, rng_name = None, ""
        for h0, h1, name in host:
            if h0 > g1:
                break
            over = min(h1, g1) - max(h0, g0)
            if over <= 0:
                continue
            if name.startswith(RANGES):
                rng_name = name
            elif best is None or over > best[0] or (over == best[0] and h1 - h0 < best[1]):
                best = (over, h1 - h0, name)
        label = "/".join(x for x in (rng_name, best[2] if best else "host") if x)
        out.append([label, length / 1e6])
    return out


def count_ops(run):
    """The PyTorch operations and host syncs (SYNC_OPS) of `run()`,
    counted as they dispatch, and run's result."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = syncs = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.ops += 1
            Count.syncs += f"aten::{str(func).split('.')[1]}" in SYNC_OPS
            return func(*args, **(kwargs or {}))

    with Count():
        out = run()
    return dict(ops=Count.ops, syncs=Count.syncs), out
