"""Readers of the program's counters (portbench/metrics/) on a window's
records: the value they read, and nothing where the program keeps no such
counters."""

import pytest

from portbench import harness


def _stats(*counters):
    return {"setup_s": 1.0, "stats": [{"total": 0.5, "counters": c} for c in counters]}


@pytest.mark.parametrize("name", ["sweep_table_hit_share.render",
                                  "sweep_table_hit_share.datagen"])
def test_sweep_table_hit_share(name):
    read = harness.reader(name)
    hit, build = {"sweep_table.hits": 1}, {"sweep_table.builds": 1}
    assert read(_stats(hit, hit, build)) == 100.0
    assert read(_stats(build, build, hit)) == 0.0
    assert read(_stats(hit, build)) == 50.0
    both = {"sweep_table.hits": 3, "sweep_table.builds": 1}
    assert read(_stats(both)) == 75.0
    # the parent's records: no such counters, or no counters at all
    assert read(_stats({"closest_hit.calls": 33}, {})) is None
    assert read({"setup_s": 1.0, "stats": [{"total": 0.5}]}) is None
    assert read({"setup_s": 1.0, "stats": []}) is None
