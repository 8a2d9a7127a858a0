"""post_idle_ms: the device's idle milliseconds per profiled call (IR or
batch) in gaps whose middle the host spent in the stages after the trace
(binning outside the phases, time stats, dedup, finalize, pull, the
modular population, attenuation, predelay, flatten, filter and mix, the
corpus render's write): portbench/stages.py over torch.profiler's trace;
nothing where the program keeps no stage spans or no device operation was
profiled."""

from portbench.stages import stage_idle_ms


def read(ctx):
    return stage_idle_ms(ctx, "post")
