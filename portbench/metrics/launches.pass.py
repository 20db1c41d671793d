"""Kernel launches a pass over the traced sub-window, counted from the
profiler's device events (copies and fills left out)."""


def read(ctx):
    return ctx.trace["launches"] / ctx.trace_units if ctx.trace_units else None
