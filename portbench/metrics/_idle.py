"""The device's idle share in the steps of a run.

The profiler slows the host (a traced DMRG sweep takes about 1.5 to 2
times as long as an untraced one), so the traced steps' own wall time
overstates the idle share. The share is taken instead as one less the
device's busy seconds a traced step over the median seconds of the
window's steps before the trace, which run the same work a step with no
span and no profiler session before them (``runner``).
"""


def idle_percent(ctx):
    """100 (1 - busy a traced step / a step before the trace), or None
    where the trace saw nothing or no step came before it."""
    t = ctx.trace
    if t is None or not t.n_device or not ctx.traced:
        return None
    step = ctx.untraced_step_s()
    if not step:
        return None
    return 100 * (1 - t.busy_s / len(ctx.traced) / step)
