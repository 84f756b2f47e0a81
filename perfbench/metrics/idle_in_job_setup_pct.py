"""The device's idle time in a job's set-up and wind-down: the session's
parameters, noise and MaskedAdam (``mmnm.fused.session``), each chunk's
log fetch (``mmnm.session.fetch``) and the unpadding of the trained
parameters (``mmnm.fused.trained``), over the traced sub-window, in %."""
from perfbench import spans


def read(ctx):
    return spans.idle_pct(ctx, "mmnm.fused.session", "mmnm.session.fetch",
                          "mmnm.fused.trained")
