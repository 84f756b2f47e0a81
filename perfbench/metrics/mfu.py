"""The model's FLOP of the window's units of work (perfbench/work.py) over
the window's time at the card's fp32 peak, in %."""
from perfbench.work import PEAK_FP32_FLOPS


def read(ctx):
    flop = ctx.window.units * ctx.unit_model_flops
    return 100.0 * flop / (ctx.window.elapsed_s * PEAK_FP32_FLOPS)
