"""The device time of the fused step's wide-hidden decoder route (the
kernels named ``*_wide_hidden_kernel``) over the traced sub-window's
device-busy time, in %. None where no such kernel ran: a program without
the route, or a step that took another."""
from perfbench import work_decoder


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    route_s = work_decoder.route_device_s(ctx.trace)
    if route_s is None:
        return None
    return 100.0 * route_s / ctx.trace.busy_s
