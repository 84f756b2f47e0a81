"""Kernels launched in the traced sub-window, a unit of work (a step)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.kernels / ctx.traced_units
