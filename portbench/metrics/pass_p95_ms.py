"""The 95th percentile over all passes of the window of the time from a
pass's start (the end of the one before it, or the window's start) to
its film reaching the viewer's ``on_batch`` on the host, in ms."""

import numpy as np


def read(ctx):
    w = ctx.window
    return float(np.percentile(np.asarray(w.unit_seconds()) * 1e3, 95)) if w.units else None
