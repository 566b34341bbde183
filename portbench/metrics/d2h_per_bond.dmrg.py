"""d2h_per_bond.dmrg: device-to-host copies plus the runtime's synchronise
calls in the traced steps, over the bonds updated there (local solves). A
``.item()`` shows as one of each."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.span_counts.get("local_solve"):
        return None
    return (t.d2h_copies + t.sync_calls) / t.span_counts["local_solve"]
