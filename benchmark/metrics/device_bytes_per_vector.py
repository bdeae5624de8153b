"""device_bytes_per_vector: torch.cuda.max_memory_allocated, reset after the
warm-up and read when the window closes, over the corpus's rows."""


def read(ctx):
    if ctx.window_peak_bytes is None:
        return None
    return ctx.window_peak_bytes / ctx.rows
