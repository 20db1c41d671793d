"""``torch.cuda.max_memory_allocated()`` over the window, after a reset of
the peak at its start, in GiB."""


def read(ctx):
    return ctx.peak_window_bytes / 2**30 if ctx.peak_window_bytes is not None else None
