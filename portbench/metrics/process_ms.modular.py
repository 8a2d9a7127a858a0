"""process_ms.modular: milliseconds of the modular pipeline's stage wall
``process``, the filter bank and the mix (spans rv.filter and rv.mix: the
four biquad passes, mixdown, normalisation, the pull and the tail trim),
each ended by a device synchronisation in a stats=True call
(pipeline.render's info["timings"], flat key process), median over the
window's IRs; nothing where the program keeps no such key."""

import statistics

KEY = "process"


def read(ctx):
    xs = [s[KEY] for s in ctx["stats"] if KEY in s]
    return 1e3 * statistics.median(xs) if xs else None
