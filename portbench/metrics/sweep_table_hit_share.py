"""sweep_table_hit_share: the share of the calls' sweep tables that the
program took from its cache rather than built (its counters
sweep_table.hits and sweep_table.builds), in percent, median over the
window's calls; nothing where the program keeps no such counters."""

import statistics


def read(ctx):
    xs = []
    for s in ctx["stats"]:
        c = s.get("counters", {})
        hits, builds = c.get("sweep_table.hits", 0), c.get("sweep_table.builds", 0)
        if hits + builds:
            xs.append(100.0 * hits / (hits + builds))
    return statistics.median(xs) if xs else None
