"""graph_capture_ms: milliseconds of the span rv.graph_capture per call
(the capture and instantiation of phase B's CUDA graph, which every trace
call pays again), summed over the call's chunks or passes, median over the
window's calls that captured one; read only where the call keeps the stage
span rv.phase_b that holds it, nothing elsewhere."""

from portbench.stages import span_ms


def read(ctx):
    return span_ms(ctx, "rv.graph_capture", within="rv.phase_b")
