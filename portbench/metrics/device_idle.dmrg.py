"""device_idle.dmrg: the share of a step of DMRG sweeps in which no
operation runs on the card, in percent (see ``_idle``)."""

from portbench.metrics import _idle


def read(ctx):
    return _idle.idle_percent(ctx)
