"""population_ms.modular: milliseconds of the modular pipeline's stage wall
``population``, the population (span rv.population: the diffuse rows and the
host image dedup), each ended by a device synchronisation in a stats=True
call (pipeline.render's info["timings"], flat key population), median over
the window's IRs; nothing where the program keeps no such key."""

import statistics

KEY = "population"


def read(ctx):
    xs = [s[KEY] for s in ctx["stats"] if KEY in s]
    return 1e3 * statistics.median(xs) if xs else None
