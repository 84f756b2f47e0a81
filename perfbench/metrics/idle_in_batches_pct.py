"""The device's idle time while the program packed and uploaded a job's
rows (``mmnm.fused.batches``), over the traced sub-window, in %."""
from perfbench import spans


def read(ctx):
    return spans.idle_pct(ctx, "mmnm.fused.batches")
