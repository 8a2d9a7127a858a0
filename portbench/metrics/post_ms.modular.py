"""post_ms.modular: milliseconds of the modular pipeline's stage wall ``post``,
the post-processing up to the histogram (spans rv.attenuate, rv.predelay and
rv.flatten), each ended by a device synchronisation in a stats=True call
(pipeline.render's info["timings"], flat key post), median over the window's
IRs; nothing where the program keeps no such key."""

import statistics

KEY = "post"


def read(ctx):
    xs = [s[KEY] for s in ctx["stats"] if KEY in s]
    return 1e3 * statistics.median(xs) if xs else None
