"""``wide_exact``'s share of its bytes bound over the traced sub-window, on
the camera bounce of each step: the first launch after each step's
start, over every ray of the step's views. The launches' least time
(``roofline.wide_exact_bytes`` at the step's rays and the refit
``WideBVH``'s tables, over the memory rate) over their device time from
the profiler's events, in %."""

from portbench import roofline, trace


def read(ctx):
    sh = ctx.cell.shapes["wide_exact"]
    sec, n = trace.first_launches(ctx.trace, "wide_exact_kernel")
    if not n or sec <= 0:
        return None
    return 100.0 * n * roofline.bound_s(roofline.wide_exact_bytes(sh["rays"], sh["tables"])) / sec
