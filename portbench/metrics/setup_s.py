"""setup_s: seconds from the process's start to the first timed call: the
imports, CUDA's start, the kernels' build or load, the scene, the inputs,
the HRTF table and the warm-up calls (host clock)."""


def read(ctx):
    return ctx["setup_s"]
