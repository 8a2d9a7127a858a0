"""graph_bounce_share: the share of the trace's bounces that ran by replay
of phase B's CUDA graph (the program's counters bounces.graph and
bounces.eager), in percent, median over the window's calls; nothing where
the program keeps no such counters."""

import statistics


def read(ctx):
    xs = []
    for s in ctx["stats"]:
        c = s.get("counters", {})
        if "bounces.graph" in c and "bounces.eager" in c:
            total = c["bounces.graph"] + c["bounces.eager"]
            if total:
                xs.append(100.0 * c["bounces.graph"] / total)
    return statistics.median(xs) if xs else None
