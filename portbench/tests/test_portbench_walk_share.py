"""The walk_share reader (portbench/metrics/walk_share.py) on a window's
records: the median share of the order entries the sweeps walk, and nothing
where the program keeps no such counters."""

from portbench import harness


def _stats(*counters):
    return {"setup_s": 1.0, "stats": [{"total": 0.5, "counters": c} for c in counters]}


def test_walk_share():
    read = harness.reader("walk_share.render")
    assert read(_stats({"order.entries_kept": 25, "order.entries": 1000})) == 2.5
    calls = [{"order.entries_kept": k, "order.entries": 100} for k in (10, 3, 7)]
    assert read(_stats(*calls)) == 7.0
    assert read(_stats({"order.entries_kept": 0, "order.entries": 64})) == 0.0
    # the parent's records: no such counters, or no counters at all
    assert read(_stats({"closest_hit.calls": 33, "pair_tests.bounce": 9}, {})) is None
    assert read({"setup_s": 1.0, "stats": [{"total": 0.5}]}) is None
    assert read({"setup_s": 1.0, "stats": []}) is None
