"""The window's seconds over the optimizer steps completed in it, in ms
(each step's loss is read back, so the window ends in a synchronise)."""


def read(ctx):
    w = ctx.window
    return w.seconds / w.units * 1e3 if w.units else None
