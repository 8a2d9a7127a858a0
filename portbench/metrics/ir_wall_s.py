"""ir_wall_s: the window's seconds over the impulse responses completed in
it, each ending with its channels on the host (host clock)."""


def read(ctx):
    return ctx["window_s"] / ctx["units"] if ctx["units"] else None
