"""``wide_shade``'s share of its bytes bound over the traced sub-window, on
the camera bounce of each pass: the first launch after each pass's start,
where every lane of the chunk is live and reads its ray planes. The
launches' least time (``roofline.wide_shade_bytes`` at the chunk's width
and the accel's tables, over the memory rate) over their device time from
the profiler's events, in %. The later bounces are left out: a dead lane
reads only its alive byte, so their bytes depend on the live count, which
the harness does not see."""

from portbench import roofline, trace


def read(ctx):
    sh = ctx.cell.shapes["wide_shade"]
    sec, n = trace.first_launches(ctx.trace, "wide_shade_kernel")
    if not n or sec <= 0:
        return None
    return 100.0 * n * roofline.bound_s(roofline.wide_shade_bytes(sh["rays"], sh["tables"])) / sec
