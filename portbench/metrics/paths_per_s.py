"""Camera paths (pixel samples) of every pass completed in the window,
over the window's seconds: the passes' sizes times their count, from the
traffic, not from the program's counters."""


def read(ctx):
    w = ctx.window
    return w.units * w.work_per_unit / w.seconds if w.units else None
