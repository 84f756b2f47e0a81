"""The mean host time of a training step (``mmnm.step``), in us: the
launches, or where the launch queue is full, the wait for room in it."""
from perfbench import spans


def read(ctx):
    return spans.mean(ctx, "mmnm.step", 1e6)
