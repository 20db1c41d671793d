"""Device time a step of every kernel that is not one of the program's own
(``trace.other_time``: elementwise shading, random numbers, sorts,
gathers, reductions), over the traced sub-window, in ms."""

from portbench import trace


def read(ctx):
    return trace.other_time(ctx.trace) / ctx.trace_units * 1e3 if ctx.trace_units else None
