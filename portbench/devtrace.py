"""Reduction of a torch.profiler window to the numbers the per-layer
metrics read: the device operations with their intervals, the device's busy
time (the union of those intervals), and the idle gaps between them named
by what the host was doing when each began."""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals. Frozen copy of
    rayverb_tpu_torch/profile_render.py::_busy_us (commit
    eea2a64cd0196306bd927c9d58cc9bb86ca59de2)."""
    total = 0.0
    end = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclass
class DeviceTrace:
    """One profiled window of ``units`` IRs (or batches)."""

    device_ops: list            # (name, start_us, end_us) of every device operation
    host_ops: list              # (name, start_us, end_us) of the host's operations
    wall_s: float               # host clock over the window, ended by a sync
    units: int
    by_name: dict = field(default_factory=dict)

    def __post_init__(self):
        sums = defaultdict(float)
        for name, a, b in self.device_ops:
            sums[name] += b - a
        self.by_name = dict(sums)

    @property
    def busy_s(self) -> float:
        return busy_us([(a, b) for _, a, b in self.device_ops]) / 1e6

    def kernel_s(self, names) -> float:
        """Device seconds of the operations whose name contains one of
        ``names``."""
        return sum(v for k, v in self.by_name.items() if any(n in k for n in names)) / 1e6

    def top_ops(self, count: int = 10):
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:count]
        return [[name[:120], us / 1e6] for name, us in top]

    def idle_gaps(self, count: int = 10):
        """[host operation, idle seconds] of the device's gaps, summed by the
        innermost host operation running at each gap's middle ("host code"
        where the host ran no profiled operation: Python or numpy)."""
        merged = _merged([(a, b) for _, a, b in self.device_ops])
        hosts = sorted(self.host_ops, key=lambda h: h[1])
        starts = [h[1] for h in hosts]
        sums = defaultdict(float)
        for (_, end), (nxt, _) in zip(merged, merged[1:]):
            mid = 0.5 * (end + nxt)
            name = "host code"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 200, -1), -1):
                if hosts[j][2] >= mid:
                    name = hosts[j][0]
                    break
            sums[name] += (nxt - end) / 1e6
        top = sorted(sums.items(), key=lambda kv: -kv[1])[:count]
        return [[name[:120], s] for name, s in top]


def profile(fn, units: int, device) -> DeviceTrace:
    """Run ``fn`` (which does ``units`` IRs or batches, each ending on the
    host) under torch.profiler with CPU and CUDA activities."""
    import time

    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    dev_ops, host_ops = [], []
    for ev in prof.events():
        rng = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_ops.append(rng)
        else:
            host_ops.append(rng)
    return DeviceTrace(dev_ops, host_ops, wall, units)
