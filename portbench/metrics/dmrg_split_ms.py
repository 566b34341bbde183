"""dmrg_split_ms: the device time of the kernels launched inside a bond's
split (``dmrg._split_2site``), a bond, in the traced steps."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.span_counts.get("split"):
        return None
    return 1e3 * t.span_device_s["split"] / t.span_counts["split"]
