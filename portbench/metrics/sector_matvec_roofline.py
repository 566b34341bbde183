"""sector_matvec_roofline: the least time of the traced sector matvecs (24 D
bytes each at the memory rate, D the sector's size) over the device time of
the kernels launched inside their spans, in percent."""

from portbench.metrics import _roofline


def read(ctx):
    calls = ctx.records.get("sector_matvec", [])
    t = ctx.trace
    if t is None or not calls or not t.span_device_s.get("sector_matvec"):
        return None
    if len(calls) != t.span_counts.get("sector_matvec"):
        return None
    bound = sum(_roofline.sector_matvec_bound_s(D, dtype)
                for D, dtype in calls)
    return 100 * bound / t.span_device_s["sector_matvec"]
