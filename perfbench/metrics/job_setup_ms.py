"""A job's set-up and wind-down on the host, in ms: the session
(``mmnm.fused.session``) and the unpadding of the trained parameters
(``mmnm.fused.trained``), summed over the traced jobs, over the number of
sessions."""
from perfbench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    sessions = spans.durations(ctx.trace, "mmnm.fused.session")
    if not sessions:
        return None
    trained = spans.durations(ctx.trace, "mmnm.fused.trained")
    return 1e3 * (sum(sessions) + sum(trained)) / len(sessions)
