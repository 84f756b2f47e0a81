"""The mean host time of uploading a job's packed rows to the device
(``mmnm.fused.upload``: the step-major copy, the copy up, the cast), in
ms."""
from perfbench import spans


def read(ctx):
    return spans.mean(ctx, "mmnm.fused.upload", 1e3)
