"""sweep_table_hit_share.corpus: the share of the window's sweep tables
that the program took from its cache rather than built (its counters
sweep_table.hits and sweep_table.builds), pooled over the window's calls,
in percent: each call prepares one table, so a per-call median would read
0 or 100; nothing where the program keeps no such counters."""


def read(ctx):
    hits = builds = 0
    for s in ctx["stats"]:
        c = s.get("counters", {})
        hits += c.get("sweep_table.hits", 0)
        builds += c.get("sweep_table.builds", 0)
    return 100.0 * hits / (hits + builds) if hits + builds else None
