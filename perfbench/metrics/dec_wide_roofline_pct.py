"""The least time the card could take for the decoder pass's work of the
traced steps (perfbench/work_decoder.py, at the cell's shapes) over the
device time of the wide-hidden route's kernels, in %. None where no such
kernel ran."""
from perfbench import spec, work_decoder


def read(ctx):
    if ctx.trace is None:
        return None
    route_s = work_decoder.route_device_s(ctx.trace)
    if not route_s:
        return None
    bench = spec.load_benchmark()
    cfg = spec.config(bench, spec.workload(bench, ctx.workload)["config"])
    least = ctx.traced_units * work_decoder.decoder_pass_per_step(cfg).bound_s
    return 100.0 * least / route_s
