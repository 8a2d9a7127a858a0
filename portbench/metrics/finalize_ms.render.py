"""finalize_ms.render: milliseconds of the render_fused(stats=True) phase wall finalize (device-synchronised), median over the window's IRs."""

import statistics

PHASE = "finalize"


def read(ctx):
    xs = [s[PHASE] for s in ctx["stats"] if PHASE in s]
    return 1e3 * statistics.median(xs) if xs else None
