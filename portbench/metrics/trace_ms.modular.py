"""trace_ms.modular: milliseconds of the modular pipeline's stage wall
``trace``, the dense trace (span rv.dense_trace: the Raytracer's table build
and the trace), each ended by a device synchronisation in a stats=True call
(pipeline.render's info["timings"], flat key trace), median over the
window's IRs; nothing where the program keeps no such key."""

import statistics

KEY = "trace"


def read(ctx):
    xs = [s[KEY] for s in ctx["stats"] if KEY in s]
    return 1e3 * statistics.median(xs) if xs else None
