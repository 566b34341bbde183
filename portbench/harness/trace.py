"""The device trace of a traced run: ``torch.profiler`` over a few steps of
the window, reduced to what the per-layer metrics read.

- Device operations are the profiler's CUDA activities (kernels, copies,
  fills), less the ranges it mirrors from ``record_function``.
- A device operation belongs to a span where the host call that launched it
  (the CUDA runtime event of the same correlation id) started inside that
  span's range on the host.
- The traced window runs from the start of the first profiled step's range
  to the end of the last one's; ``busy_s`` is the union of the device
  operations' intervals inside it.
- Host waits are device-to-host copies and the runtime's synchronise calls.
"""

import collections
from dataclasses import dataclass, field

import numpy as np

from portbench.harness.spans import PREFIX

SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize"})
#: top entries of each list of the breakdown
TOP = 10


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    n_device: int = 0
    #: device seconds of the operations launched inside each span kind
    span_device_s: dict = field(default_factory=dict)
    #: ranges of each span kind in the traced window
    span_counts: dict = field(default_factory=dict)
    d2h_copies: int = 0
    sync_calls: int = 0
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


@dataclass
class Event:
    """One profiler event, in the trace's own nanoseconds."""
    name: str
    start: int
    end: int
    device: bool
    corr: int = 0
    thread: int = 0


def kineto_events(prof, torch):
    """The profiler's raw events as :class:`Event` objects."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        device = e.device_type() == cuda
        if device and (e.is_user_annotation() or name.startswith(PREFIX)):
            continue
        out.append(Event(name, e.start_ns(), e.end_ns(), device,
                         e.correlation_id(), e.start_thread_id()))
    return out


def _merged(intervals):
    """The union of ``(start, end)`` intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(times, ranges):
    """Which of ``times`` fall inside one of the ``ranges`` (start, end),
    ranges that do not overlap each other."""
    if not ranges:
        return np.zeros(len(times), bool)
    ranges = sorted(ranges)
    starts = np.array([r[0] for r in ranges])
    ends = np.array([r[1] for r in ranges])
    times = np.asarray(times)
    idx = np.searchsorted(starts, times, side="right") - 1
    ok = idx >= 0
    return ok & (times <= ends[np.maximum(idx, 0)])


def reduce(events):
    """The :class:`Trace` of a list of :class:`Event`."""
    spans = collections.defaultdict(list)
    launch = {}
    host = []
    t = Trace()
    for e in events:
        if e.device:
            continue
        if e.name.startswith(PREFIX):
            spans[e.name[len(PREFIX):]].append((e.start, e.end))
        elif e.name.startswith("cu"):
            launch[e.corr] = e.start
        host.append(e)
    steps = spans.pop("step", [])
    if not steps:
        return t
    w0, w1 = min(s for s, _ in steps), max(e for _, e in steps)
    t.window_s = (w1 - w0) / 1e9
    dev = [e for e in events if e.device and w0 <= e.start and e.end <= w1]
    t.n_device = len(dev)
    t.d2h_copies = sum("DtoH" in e.name for e in dev)
    t.sync_calls = sum(1 for e in host if e.name in SYNC_CALLS
                       and w0 <= e.start <= w1)
    busy = _merged((e.start, e.end) for e in dev)
    t.busy_s = sum(e - s for s, e in busy) / 1e9

    dur = np.array([e.end - e.start for e in dev], dtype=np.float64)
    at = [launch.get(e.corr, -1) for e in dev]
    for kind, ranges in spans.items():
        inside = [(s, e) for s, e in ranges if w0 <= s <= w1]
        t.span_counts[kind] = len(inside)
        t.span_device_s[kind] = float(dur[_inside(at, inside)].sum()) / 1e9

    by_name = collections.Counter()
    for e, d in zip(dev, dur):
        by_name[e.name[:120]] += d / 1e9
    t.device_ops = [[n, s] for n, s in by_name.most_common(TOP)]
    t.idle_gaps = _gap_labels(busy, w0, w1, host)
    return t


def _gap_labels(busy, w0, w1, host):
    """The traced window's idle time by what the host was doing at the
    middle of each gap: the innermost host event there on the thread that
    runs the steps, and the innermost span of the benchmark around it.
    One pass over the gaps and the events, both in time order, with a
    stack of the events open at the current time."""
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    thread = collections.Counter(e.thread for e in host
                                 if e.name.startswith(PREFIX))
    main = thread.most_common(1)[0][0] if thread else None
    ops = sorted((e for e in host if e.thread == main),
                 key=lambda e: (e.start, -e.end))
    totals = collections.Counter()
    stack, i = [], 0
    for s, e in gaps:
        mid = (s + e) // 2
        while i < len(ops) and ops[i].start <= mid:
            while stack and stack[-1].end < ops[i].start:
                stack.pop()
            stack.append(ops[i])
            i += 1
        label, span = None, None
        for ev in reversed(stack):
            if ev.end < mid:
                continue
            if ev.name.startswith(PREFIX):
                span = span or ev.name[len(PREFIX):]
            else:
                label = label or ev.name
            if label and span:
                break
        totals[f"{(label or 'python')[:80]} in {span or 'step'}"] += \
            (e - s) / 1e9
    return [[n, s] for n, s in totals.most_common(TOP)]


class Profile:
    """One profiler session over some steps of the window."""

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)

    def trace(self):
        return reduce(kineto_events(self.prof, self.torch))


def warm_profiler(torch, device):
    """A throwaway session: the profiler's first start on a card sets up
    CUPTI, which takes seconds, so a traced run pays it in set-up."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)
