"""pre_idle_ms: the device's idle milliseconds per profiled call (IR or
batch) in gaps whose middle the host spent in the call's preparation
(rv.prepare, and the corpus render's rv.config, rv.load_scene,
rv.directions; datagen's rv.inputs; the modular rv.sweep_table):
portbench/stages.py over torch.profiler's trace; nothing where the program
keeps no stage spans or no device operation was profiled."""

from portbench.stages import stage_idle_ms


def read(ctx):
    return stage_idle_ms(ctx, "pre")
