"""The reduction of a profiler window: busy union, sums by name, and idle
gaps named by the host operation at their middle."""

import pytest

from portbench.devtrace import DeviceTrace, busy_us


def test_busy_union_and_gaps():
    dev = [("sweep", 0.0, 10.0), ("sort", 5.0, 12.0), ("sweep", 20.0, 30.0), ("fill", 100.0, 110.0)]
    host = [("render", 0.0, 200.0), ("aten::sort", 13.0, 19.0)]
    t = DeviceTrace(dev, host, wall_s=200e-6, units=2)
    assert busy_us([(a, b) for _, a, b in dev]) == 32.0
    assert t.busy_s == pytest.approx(32e-6)
    assert t.kernel_s(("sweep",)) == pytest.approx(20e-6)
    assert t.top_ops()[0] == ["sweep", pytest.approx(20e-6)]
    gaps = dict(map(tuple, t.idle_gaps()))
    assert gaps == {"render": pytest.approx(70e-6), "aten::sort": pytest.approx(8e-6)}
    assert DeviceTrace(dev, [], 1.0, 1).idle_gaps()[0][0] == "host code"
