"""The mean host time of packing a job's rows into the step's padded
batch layout (``mmnm.fused.pack``, numpy), in ms."""
from perfbench import spans


def read(ctx):
    return spans.mean(ctx, "mmnm.fused.pack", 1e3)
