"""The least time the card could take for a unit's work (perfbench/work.py)
over the unit's device-busy time in the traced sub-window, in %."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * ctx.traced_units * ctx.unit_work.bound_s / ctx.trace.busy_s
