"""dg_bin_ms.datagen: milliseconds of the render_irs_batched(stats=True) phase wall bin (device-synchronised), median over the window's batches."""

import statistics

PHASE = "bin"


def read(ctx):
    xs = [s[PHASE] for s in ctx["stats"] if PHASE in s]
    return 1e3 * statistics.median(xs) if xs else None
