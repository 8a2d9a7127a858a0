"""biquad_ms.modular: device milliseconds per profiled call of the
biquad_scan kernel (csrc/biquad_scan.cu: every pass of the filter bank),
from torch.profiler's trace; nothing where no such kernel ran."""

KERNELS = ("biquad_scan",)


def read(ctx):
    prof = ctx["profile"]
    if prof is None:
        return None
    s = prof.kernel_s(KERNELS)
    return 1e3 * s / prof.units if s > 0 else None
