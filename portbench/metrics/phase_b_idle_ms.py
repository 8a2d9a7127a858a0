"""phase_b_idle_ms: the device's idle milliseconds per profiled call (IR or
batch) in gaps whose middle the host spent in the trace's phase B
(rv.phase_b: the pure diffuse bounces, their graph's capture and replays,
and the binning of their rows): portbench/stages.py over torch.profiler's
trace; nothing where the program keeps no stage spans or no device
operation was profiled."""

from portbench.stages import stage_idle_ms


def read(ctx):
    return stage_idle_ms(ctx, "phase_b")
