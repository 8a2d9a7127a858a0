"""sweep_ms: device milliseconds per profiled call of the closest-hit
kernels named in KERNELS (csrc/closest_hit.cu), from torch.profiler's
trace."""

KERNELS = ("closest_hit_sweep", "closest_hit_order")


def read(ctx):
    prof = ctx["profile"]
    if prof is None:
        return None
    s = prof.kernel_s(KERNELS)
    return 1e3 * s / prof.units if s > 0 else None
