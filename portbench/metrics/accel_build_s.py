"""Seconds of the accel's build on the host (``build_shaded_accel`` or
``make_accel``), on the host clock around the call in set-up."""


def read(ctx):
    return ctx.cell.accel_build_s
