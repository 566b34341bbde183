"""ed_solve_s: the window's seconds over the ground-energy solves completed
in it, by the host clock."""


def read(ctx):
    return ctx.window_s / ctx.steps if ctx.steps else None
