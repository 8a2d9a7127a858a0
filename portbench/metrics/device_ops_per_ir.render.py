"""device_ops_per_ir.render: device operations (kernels, copies, fills) per
profiled IR, from torch.profiler's trace."""


def read(ctx):
    prof = ctx["profile"]
    if prof is None or not prof.device_ops:
        return None
    return len(prof.device_ops) / prof.units
