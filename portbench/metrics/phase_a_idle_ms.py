"""phase_a_idle_ms: the device's idle milliseconds per profiled call (IR or
batch) in gaps whose middle the host spent in the trace's phase A
(rv.phase_a: the direct path and the image-source bounces, and the binning
of their rows): portbench/stages.py over torch.profiler's trace; nothing
where the program keeps no stage spans or no device operation was
profiled."""

from portbench.stages import stage_idle_ms


def read(ctx):
    return stage_idle_ms(ctx, "phase_a")
