"""dg_trace_ms.datagen: milliseconds of the render_irs_batched(stats=True) phase wall trace (device-synchronised), median over the window's batches."""

import statistics

PHASE = "trace"


def read(ctx):
    xs = [s[PHASE] for s in ctx["stats"] if PHASE in s]
    return 1e3 * statistics.median(xs) if xs else None
