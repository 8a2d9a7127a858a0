"""phase_a_ms: milliseconds of the trace's stage span rv.phase_a (the
direct path and the min(R, 9) image-source bounces, ended by a device
synchronisation in a stats=True call) per call, summed over the call's
chunks or passes, median over the window's calls; nothing where the
program keeps no such span."""

from portbench.stages import span_ms


def read(ctx):
    return span_ms(ctx, "rv.phase_a")
