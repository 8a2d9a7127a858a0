"""finalize_ms.corpus: milliseconds of the fused render's phase wall
finalize (device-synchronised, the filter parameters' lookup included; a
flat key of the render nested in the CLI render's call), median over the
window's calls; nothing where the program keeps no such key."""

import statistics

KEY = "finalize"


def read(ctx):
    xs = [s[KEY] for s in ctx["stats"] if KEY in s]
    return 1e3 * statistics.median(xs) if xs else None
