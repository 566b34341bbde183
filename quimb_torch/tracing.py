"""Named ranges inside quimb_torch, for a ``torch.profiler`` session.

While a session records, :func:`span` opens a ``record_function`` range
named ``quimb_torch.<name>``. It lands in the session's trace beside the
device activity launched inside it, on the same clock, and ranges nest by
the host thread. With no session it returns one shared null context, at
the cost of reading a flag. There is no switch, no counter and no
exporter: the session is the switch, and its trace the record. Names are
constants, so a reader can add up the ranges of one kind.
"""

import contextlib
import functools

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

PREFIX = "quimb_torch."
_OFF = contextlib.nullcontext()


def span(name):
    """The range ``quimb_torch.<name>`` while a profiler session records,
    else a shared null context."""
    if _profiler_enabled():
        return record_function(PREFIX + name)
    return _OFF


def spanned(name):
    """Decorator: every call of the function runs inside ``span(name)``."""
    full = PREFIX + name

    def wrap(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with record_function(full):
                return fn(*args, **kwargs)

        return wrapped

    return wrap
