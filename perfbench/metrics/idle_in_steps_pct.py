"""The device's idle time inside the training steps (``mmnm.step``: the
inputs, the fused kernel, the logs, MaskedAdam), over the traced
sub-window, in %."""
from perfbench import spans


def read(ctx):
    return spans.idle_pct(ctx, "mmnm.step")
