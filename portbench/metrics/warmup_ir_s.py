"""warmup_ir_s: seconds of the set-up's warm-up calls of the cell's own
shapes (lazy init, kernel loads, cuFFT plans), ended by a device sync."""


def read(ctx):
    return ctx["spans"].get("warmup_ir_s")
