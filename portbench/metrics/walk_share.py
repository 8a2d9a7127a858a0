"""walk_share: the share of the order entries that the sweeps walk (the
program's counters order.entries_kept: the entries the order kernel's cull
keeps, over order.entries: groups x table blocks, summed over the counted
sweeps), in percent, median over the window's calls; nothing where the
program keeps no such counters."""

import statistics


def read(ctx):
    xs = []
    for s in ctx["stats"]:
        c = s.get("counters", {})
        entries = c.get("order.entries", 0)
        if entries:
            xs.append(100.0 * c.get("order.entries_kept", 0) / entries)
    return statistics.median(xs) if xs else None
