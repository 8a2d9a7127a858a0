"""closest_hit_host_us: host microseconds per closest-hit call, the
program's span rv.closest_hit (its total over its count in a call: the
schedule, the two launches and their tensors), median over the window's
calls; nothing where the program keeps no spans."""

import statistics

SPAN = "rv.closest_hit"


def read(ctx):
    xs = [s["spans"][SPAN]["s"] / s["spans"][SPAN]["n"] for s in ctx["stats"]
          if s.get("spans", {}).get(SPAN, {}).get("n")]
    return 1e6 * statistics.median(xs) if xs else None
