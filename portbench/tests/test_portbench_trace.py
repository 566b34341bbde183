"""The reduction of a device trace to what the per-layer metrics read, on
a made-up trace, and the metrics' readers on it."""

import pytest
import torch

from portbench.harness import registry
from portbench.harness.runner import Context
from portbench.harness.trace import Event, reduce


def _trace():
    """Two steps on the host (0-100 and 100-200 ns); inside the first a
    ``sandwich`` span (10-40) that launches two kernels and a ``split``
    span (50-70) that launches a kernel and reads a value back; the second
    step launches one kernel outside any span, then synchronises."""
    cpu = [
        Event("portbench.step", 0, 100, False, 1, 7),
        Event("portbench.step", 100, 200, False, 2, 7),
        Event("portbench.sandwich", 10, 40, False, 3, 7),
        Event("portbench.split", 50, 70, False, 4, 7),
        Event("cudaLaunchKernel", 12, 14, False, 101, 7),
        Event("cudaLaunchKernel", 20, 22, False, 102, 7),
        Event("cudaLaunchKernel", 52, 53, False, 103, 7),
        Event("cudaMemcpyAsync", 60, 62, False, 104, 7),
        Event("aten::item", 58, 66, False, 55, 7),
        Event("cudaLaunchKernel", 110, 111, False, 105, 7),
        Event("cudaStreamSynchronize", 150, 190, False, 106, 7),
    ]
    dev = [
        Event("gemm_dmma", 20, 30, True, 101),
        Event("sum_partials_f64", 30, 35, True, 102),
        Event("svd", 55, 60, True, 103),
        Event("Memcpy DtoH (Device -> Pageable)", 61, 62, True, 104),
        Event("gemm_dmma", 120, 150, True, 105),
    ]
    return reduce(cpu + dev)


def test_window_busy_and_host_waits():
    t = _trace()
    assert t.window_s == pytest.approx(200e-9)
    assert t.busy_s == pytest.approx((15 + 5 + 1 + 30) * 1e-9)
    assert t.n_device == 5
    assert (t.d2h_copies, t.sync_calls) == (1, 1)


def test_device_time_by_span_of_launch():
    t = _trace()
    assert t.span_counts == {"sandwich": 1, "split": 1}
    assert t.span_device_s["sandwich"] == pytest.approx(15e-9)
    assert t.span_device_s["split"] == pytest.approx(6e-9)


def test_breakdown():
    t = _trace()
    assert t.device_ops[0] == ["gemm_dmma", pytest.approx(40e-9)]
    labels = dict(t.idle_gaps)
    # 150-200: the host waits in a synchronise call
    assert labels["cudaStreamSynchronize in step"] == pytest.approx(50e-9)
    # 0-20: the host is in the sandwich span, in Python, at 10 ns
    assert labels["python in sandwich"] == pytest.approx(20e-9)


def _ctx(trace, records=None, counts=None, steps=2, step_s=(), traced=(),
         counted=0):
    return Context(5.0, 10.0, steps, counts or {}, records or {}, trace,
                   {}, {}, list(step_s), list(traced), counted)


def test_metric_readers_on_the_trace():
    t = _trace()
    calls = [((5, 512, 512), (5, 512, 512), torch.float64)]
    read = registry.metric_reader
    roof = read("sandwich_roofline")(_ctx(t, {"sandwich": calls}))
    assert roof == pytest.approx(100 * 4.0065e-5 / 15e-9, rel=1e-4)
    assert read("dmrg_split_ms")(_ctx(t)) == pytest.approx(6e-6)
    # no step before the trace to measure a step's time by
    assert read("device_idle.dmrg")(_ctx(t, step_s=[1, 1, 1],
                                         traced=[0, 1])) is None
    # two steps traced, busy 51 ns in all; the median of the three steps
    # before them 100 ns (the slower one after them left out)
    ctx = _ctx(t, step_s=[90e-9, 100e-9, 300e-9, 50e-9, 50e-9, 999e-9],
               traced=[3, 4])
    assert read("device_idle.dmrg")(ctx) == pytest.approx(
        100 * (1 - 25.5 / 100))
    assert read("device_idle.ed")(ctx) == read("device_idle.dmrg")(ctx)
    assert read("d2h_per_bond.dmrg")(_ctx(t)) is None      # no local solve
    # over the steps run under the spans, not over the whole window
    assert read("ed_matvecs_per_solve")(
        _ctx(t, counts={"sector_matvec": 160}, steps=5, counted=2)) == 80
    assert read("ed_matvecs_per_solve")(
        _ctx(t, counts={"sector_matvec": 160}, steps=5)) is None
    assert read("dmrg_sweep_s")(_ctx(None)) == 5.0
    assert read("setup_s")(_ctx(None)) == 5.0


def test_readers_find_nothing_without_a_trace():
    for name in ("sandwich_roofline", "dmrg_split_ms", "d2h_per_bond.dmrg",
                 "device_idle.dmrg", "device_idle.ed",
                 "sector_matvec_roofline"):
        assert registry.metric_reader(name)(_ctx(None)) is None
    assert registry.metric_reader("sandwich_roofline")(
        _ctx(reduce([]), {"sandwich": []})) is None
