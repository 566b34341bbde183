"""dmrg_sweep_s: the window's seconds over the sweeps completed in it,
episode starts included, by the host clock."""


def read(ctx):
    return ctx.window_s / ctx.steps if ctx.steps else None
