"""phase_b_ms: milliseconds of the trace's stage span rv.phase_b (the pure
diffuse bounces: the capture of their CUDA graph and its replays, or the
eager bounces; ended by a device synchronisation in a stats=True call) per
call, summed over the call's chunks or passes, median over the window's
calls; nothing where the program keeps no such span."""

from portbench.stages import span_ms


def read(ctx):
    return span_ms(ctx, "rv.phase_b")
