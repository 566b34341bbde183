"""The program's own ranges (``quimb_torch.tracing``, ``quimb_torch.<span>``)
in a made-up trace: with their device mirrors, they leave every field of
the reduced trace, but the names of the idle gaps, and every metric
reader's value as they were without them."""

import pytest
import torch

from portbench.harness import registry
from portbench.harness.runner import Context
from portbench.harness.trace import kineto_events, reduce

#: the trace of ``test_portbench_trace``: two steps (0-100, 100-200 ns), a
#: ``sandwich`` span launching two kernels inside a ``local_solve`` span, a
#: ``split`` span launching a kernel and reading a value back, and a
#: ``sector_matvec`` span launching a kernel in the second step, which then
#: synchronises; (name, start, end, device, correlation id)
EVENTS = [
    ("portbench.step", 0, 100, False, 1),
    ("portbench.step", 100, 200, False, 2),
    ("portbench.sandwich", 10, 40, False, 3),
    ("portbench.split", 50, 70, False, 4),
    ("portbench.local_solve", 8, 45, False, 5),
    ("portbench.sector_matvec", 108, 140, False, 6),
    ("cudaLaunchKernel", 12, 14, False, 101),
    ("cudaLaunchKernel", 20, 22, False, 102),
    ("cudaLaunchKernel", 52, 53, False, 103),
    ("cudaMemcpyAsync", 60, 62, False, 104),
    ("aten::item", 58, 66, False, 55),
    ("cudaLaunchKernel", 110, 111, False, 105),
    ("cudaStreamSynchronize", 150, 190, False, 106),
    ("gemm_dmma", 20, 30, True, 101),
    ("sum_partials_f64", 30, 35, True, 102),
    ("svd", 55, 60, True, 103),
    ("Memcpy DtoH (Device -> Pageable)", 61, 62, True, 104),
    ("gemm_dmma", 120, 150, True, 105),
    # the harness's own range, mirrored on the device
    ("portbench.sandwich", 12, 38, True, 950),
]

#: the program's ranges planted in it: a bond (5-75) holding a local
#: solve, its restart, a matvec and the split; an environment step
#: (105-195) around the second step's kernel and its synchronise, with a
#: second restart (145-155) inside it
PROGRAM = [("bond", 5, 75), ("local_solve", 8, 45),
           ("lanczos_restart", 9, 44), ("sandwich", 11, 39),
           ("split", 51, 69), ("env_step", 105, 195),
           ("lanczos_restart", 145, 155)]

#: the fields a reduced trace has, but the idle gaps' names
FIELDS = ("window_s", "busy_s", "n_device", "span_device_s", "span_counts",
          "d2h_copies", "sync_calls", "device_ops")


class _Kineto:
    """A kineto event of the profiler, as ``kineto_events`` reads it."""

    def __init__(self, name, start, end, device, corr, annotation=False):
        self._e = (name, start, end, device, corr, annotation)

    def name(self):
        return self._e[0]

    def start_ns(self):
        return self._e[1]

    def end_ns(self):
        return self._e[2]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._e[3]
                else torch.autograd.DeviceType.CPU)

    def correlation_id(self):
        return self._e[4]

    def start_thread_id(self):
        return 7

    def is_user_annotation(self):
        return self._e[5]


class _Prof:
    """A finished session over ``events``, as ``kineto_events`` reads it."""

    def __init__(self, events):
        results = type("Results", (), {"events": lambda _: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def _trace(program):
    """The reduced trace of :data:`EVENTS` with the ranges ``program`` on
    the host and their mirrors on the device, which the profiler marks as
    user annotations, as it marks the harness's."""
    events = [_Kineto(*e, annotation=e[0].startswith("portbench.") and e[3])
              for e in EVENTS]
    for i, (kind, s, e) in enumerate(program):
        name = "quimb_torch." + kind
        events.append(_Kineto(name, s, e, False, 900 + i))
        events.append(_Kineto(name, s + 1, e + 1, True, 900 + i,
                              annotation=True))
    return reduce(kineto_events(_Prof(events), torch))


def _ctx(trace):
    calls = [((5, 512, 512), (5, 512, 512), torch.float64)]
    return Context(5.0, 10.0, 2, {"sector_matvec": 160},
                   {"sandwich": calls,
                    "sector_matvec": [(2704156, torch.float64)]}, trace,
                   {}, {}, [90e-9, 100e-9, 300e-9, 50e-9, 50e-9], [3, 4], 2)


def test_the_made_up_trace_reads_as_its_twin():
    t = _trace([])
    assert t.window_s == pytest.approx(200e-9)
    assert t.busy_s == pytest.approx((15 + 5 + 1 + 30) * 1e-9)
    assert (t.n_device, t.d2h_copies, t.sync_calls) == (5, 1, 1)
    assert t.span_counts == {"sandwich": 1, "split": 1, "local_solve": 1,
                             "sector_matvec": 1}


@pytest.mark.parametrize("name", FIELDS)
def test_program_ranges_leave_the_field(name):
    assert getattr(_trace(PROGRAM), name) == getattr(_trace([]), name)


def test_program_ranges_leave_the_idle_seconds():
    plain, spanned = _trace([]), _trace(PROGRAM)
    assert sum(s for _, s in spanned.idle_gaps) == pytest.approx(
        sum(s for _, s in plain.idle_gaps))


@pytest.mark.parametrize(
    "name", [m["name"] for m in registry.load_benchmark()["per_layer"]])
def test_program_ranges_leave_the_reader(name):
    read = registry.metric_reader(name)
    plain = read(_ctx(_trace([])))
    assert plain is not None
    assert read(_ctx(_trace(PROGRAM))) == plain
