"""ed_matvecs_per_solve: calls of the sector operator's matvec over the
solves run under the spans (from the trace's start to the window's end),
by the benchmark's counting wrapper."""


def read(ctx):
    n = ctx.counts.get("sector_matvec")
    return n / ctx.counted if n and ctx.counted else None
