"""setup_s: the start of the process to the start of the window (host clock)."""


def read(ctx):
    return ctx.setup_s
