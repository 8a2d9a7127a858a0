"""trace_bin_ms.render: milliseconds of the render_fused(stats=True) phase wall trace_bin (device-synchronised), median over the window's IRs."""

import statistics

PHASE = "trace_bin"


def read(ctx):
    xs = [s[PHASE] for s in ctx["stats"] if PHASE in s]
    return 1e3 * statistics.median(xs) if xs else None
