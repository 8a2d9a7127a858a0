"""live_row_share: the bounce sweeps' live rows (the program's counter
live_rows.bounce: rows that enter a bounce sweep with t_max > 0) over the
rows that the bounce sweeps carry (rays x reflections x pairs of the run),
in percent, median over the window's calls; nothing where the program
keeps no such counter."""

import statistics


def read(ctx):
    xs = [s["counters"]["live_rows.bounce"] for s in ctx["stats"]
          if "live_rows.bounce" in s.get("counters", {})]
    if not xs:
        return None
    rows = ctx["rays"] * ctx["reflections"] * ctx["pairs"]
    return 100.0 * statistics.median(xs) / rows
