"""Spans and counters that the benchmark puts around calls into the program.

In a traced run a driver wraps the program at the names it looks up when it
calls them. Each wrapped call is counted, runs inside a
``torch.profiler.record_function`` range named ``portbench.<span>``, and,
while :attr:`Spans.recording` is on (the profiled steps), may record what
the metrics need to know of it, such as its operands' shapes.
"""

import collections

from torch.profiler import record_function

PREFIX = "portbench."


class Spans:
    """The wrappers of one run, their counts and records."""

    def __init__(self):
        self.counts = collections.Counter()
        self.records = collections.defaultdict(list)
        self.recording = False
        self._undo = []

    def wrap(self, span, fn, record=None):
        """``fn`` counted and run inside the range ``portbench.<span>``;
        ``record(*args, **kwargs)`` is kept while recording."""
        name = PREFIX + span

        def wrapped(*args, **kwargs):
            self.counts[span] += 1
            if self.recording and record is not None:
                self.records[span].append(record(*args, **kwargs))
            with record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    def patch(self, owner, attr, span, record=None):
        """Replace ``owner.attr`` by its wrapper until :meth:`restore`."""
        orig = getattr(owner, attr)
        self._undo.append((owner, attr, orig))
        setattr(owner, attr, self.wrap(span, orig, record))

    def restore(self):
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)

    def step(self):
        """The range of one step of the window."""
        return record_function(PREFIX + "step")
