"""The device's idle share over the traced sub-window of steps: 1 - the
union of its events' intervals over the sub-window's length, in %."""


def read(ctx):
    tr = ctx.trace
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"]) if tr["window_s"] > 0 else None
