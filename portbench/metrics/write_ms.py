"""write_ms: milliseconds of the CLI render's flat wall ``write`` (span
rv.write: the audio file's encoding and write), median over the window's
calls; nothing where the program keeps no such key."""

import statistics

KEY = "write"


def read(ctx):
    xs = [s[KEY] for s in ctx["stats"] if KEY in s]
    return 1e3 * statistics.median(xs) if xs else None
