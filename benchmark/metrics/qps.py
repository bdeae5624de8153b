"""qps: queries answered in the window over the window's seconds (host clock)."""


def read(ctx):
    w = ctx.window
    return w["answered"] / w["window_s"] if w["window_s"] > 0 else None
