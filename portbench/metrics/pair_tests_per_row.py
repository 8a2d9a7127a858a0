"""pair_tests_per_row: the sweep kernel's executed ray-triangle pair tests
(the program's counters pair_tests.<kind>, summed over the kinds) per
closest-hit row (closest_hit.rows), median over the window's calls;
nothing where the program keeps no such counters."""

import statistics

KINDS = ("bounce", "imgvis", "seg", "shadow")


def read(ctx):
    xs = []
    for s in ctx["stats"]:
        c = s.get("counters", {})
        if c.get("closest_hit.rows") and all(f"pair_tests.{k}" in c for k in KINDS):
            xs.append(sum(c[f"pair_tests.{k}"] for k in KINDS) / c["closest_hit.rows"])
    return statistics.median(xs) if xs else None
