"""peak_mem_gib: the device's peak allocated memory over the traced
window's calls (torch.cuda.max_memory_allocated after
reset_peak_memory_stats), GiB."""


def read(ctx):
    return ctx["peak_bytes"] / 2**30 if ctx["peak_bytes"] else None
