"""pairs_per_s: source/mic pairs completed over the window's seconds, each
batch ending with its impulse responses on the host (host clock)."""


def read(ctx):
    return ctx["units"] * ctx["pairs"] / ctx["window_s"] if ctx["window_s"] > 0 else None
