"""prepare_ms: milliseconds of the program's span rv.prepare (the call's
host preparation: sweep table, ray order, attenuation spec, filter
parameters), median over the window's calls (their stats=True
``timings["spans"]``); nothing where the program keeps no spans."""

import statistics

SPAN = "rv.prepare"


def read(ctx):
    xs = [s["spans"][SPAN]["s"] for s in ctx["stats"] if SPAN in s.get("spans", {})]
    return 1e3 * statistics.median(xs) if xs else None
