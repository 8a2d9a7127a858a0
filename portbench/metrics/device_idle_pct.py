"""device_idle_pct: 100 minus the share of the profiled calls' wall in
which some operation ran on the device (the union of the device
intervals, torch.profiler's trace)."""


def read(ctx):
    prof = ctx["profile"]
    if prof is None or not prof.device_ops or prof.wall_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.wall_s)
