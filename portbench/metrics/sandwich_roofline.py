"""sandwich_roofline: the least time of the traced sandwich matvecs (each
from its operands' shapes and dtype) over the device time of the kernels
launched inside their spans, in percent."""

from portbench.metrics import _roofline


def read(ctx):
    calls = ctx.records.get("sandwich", [])
    t = ctx.trace
    if t is None or not calls or not t.span_device_s.get("sandwich"):
        return None
    if len(calls) != t.span_counts.get("sandwich"):
        return None
    bound = sum(_roofline.sandwich_bound_s(a, b, dtype)
                for a, b, dtype in calls)
    return 100 * bound / t.span_device_s["sandwich"]
