"""One run of one cell: set-up, warm-up, the measured window, the check of
what the window produced against the plain reference, and the result.

The window runs the driver's steps back to back and closes at the first
boundary of a whole answer (a DMRG episode, a solve) after ``seconds``.
Each step ends in a synchronise, and its seconds are kept. A traced run
runs the first ``trace_skip`` steps of the window as an untraced run does;
then it starts the profiler once (its first session on a card sets up
CUPTI), wraps the program in the driver's spans and profiles the next
``trace_steps`` steps (again, up to three times, where a session records
no device activity). So the steps before the trace are timed with no
profiler session and no span before them. Its metrics are the cell's
per-layer ones.
"""

import math
import statistics
import time
from dataclasses import dataclass

from portbench.harness import registry
from portbench.harness import spans as spans_mod
from portbench.harness import trace as trace_mod

PROFILE_TRIES = 3


@dataclass
class Context:
    """What a metric's reader reads."""
    setup_s: float
    window_s: float
    steps: int
    counts: dict
    records: dict
    trace: object
    config: dict
    mix: dict
    #: host seconds of each step of the window
    step_s: list
    #: the indices of the steps the trace covers
    traced: list
    #: the steps run under the spans, whose calls ``counts`` holds
    counted: int = 0

    def untraced_step_s(self):
        """The median seconds of the window's steps before the trace, or
        None where there are none. They ran with no span and no profiler
        session before them; steps after the first session are left out,
        as they run slower for a while once a session has ended."""
        before = self.step_s[:self.traced[0]] if self.traced else []
        return statistics.median(before) if before else None


def plain_sandwich(prepare):
    """A prepare step in the program's place: the plain einsum of the
    sandwich matvec, ``sum_x a[x] @ theta @ b[x]``."""
    import torch

    def prepared(a, b):
        return lambda theta: torch.einsum("xmk,kl,xln->mn", a, theta, b)

    return prepared


def lower_sandwich(prepare):
    """The plain einsum of the sandwich matvec in the precision below the
    operands' (complex64 for complex128, float32 for float64), its result
    cast back: the reference in the program's place, a precision lower."""
    import torch

    lower = {torch.complex128: torch.complex64, torch.float64: torch.float32}

    def prepared(a, b):
        low = lower[a.dtype]
        al, bl = a.to(low), b.to(low)
        return lambda theta: torch.einsum(
            "xmk,kl,xln->mn", al, theta.to(low), bl).to(theta.dtype)

    return prepared


SANDWICHES = {"plain": plain_sandwich, "lower": lower_sandwich}


def run(spec, seed, seconds, trace, device, program, torch, t_start,
        variant=None):
    """Run the cell of ``spec`` (:func:`registry.cell_spec`) on ``device``
    with the ``program`` module; return the result as a dict, its
    ``checks`` last, and the host seconds of each step of the window. ``variant`` puts a control in the program's place: a
    ``mix`` of overrides (a lower ``dtype``), ``tf32`` to let float32
    products run in TF32, and ``sandwich`` for the plain einsum in place of
    the sandwich kernels (``"plain"``), or that einsum a precision lower
    (``"lower"``)."""
    variant = variant or {}
    mix = {**spec["mix"], **variant.get("mix", {})}
    cuda = torch.device(device).type == "cuda"
    drv = registry.driver(mix["algorithm"])(program, spec["config"], mix,
                                            seed, device)
    if "sandwich" in variant:
        drv.sandwich = SANDWICHES[variant["sandwich"]]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(variant.get("tf32", tf32))
    try:
        return _run(spec, mix, drv, seconds, trace, device, cuda,
                    torch, t_start)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _sync(torch, cuda):
    if cuda:
        torch.cuda.synchronize()


def _run(spec, mix, drv, seconds, trace, device, cuda, torch,
         t_start):
    sp = spans_mod.Spans() if trace else None
    drv.setup()
    drv.warmup()
    _sync(torch, cuda)
    setup_s = time.perf_counter() - t_start

    skip, nprof = int(mix["trace_skip"]), int(mix["trace_steps"])
    steps, prof, done, got, tries = 0, None, 0, None, 0
    step_s, traced, spanned = [], [], None
    t0 = time.perf_counter()
    while True:
        if sp is not None and got is None and prof is None \
                and steps >= skip and tries < PROFILE_TRIES:
            if spanned is None:
                if cuda:
                    trace_mod.warm_profiler(torch, device)
                drv.instrument(sp)
                spanned = steps
            sp.records.clear()
            sp.recording = True
            prof = trace_mod.Profile(torch).__enter__()
            done = 0
        ts = time.perf_counter()
        if sp is not None:
            with sp.step():
                drv.step()
        else:
            drv.step()
        _sync(torch, cuda)
        step_s.append(time.perf_counter() - ts)
        steps += 1
        if prof is not None:
            done += 1
            if done == nprof:
                sp.recording = False
                prof.__exit__(None, None, None)
                tr, prof = prof.trace(), None
                tries += 1
                if tr.n_device:
                    got = tr
                    traced = list(range(steps - nprof, steps))
        if time.perf_counter() - t0 >= seconds and prof is None \
                and drv.at_boundary() and (
                    sp is None or got is not None or tries >= PROFILE_TRIES):
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if sp is not None:
        sp.restore()

    drv.finish()
    if cuda:
        torch.cuda.empty_cache()
    # the cell's own limits, also where a control runs in its place
    checks, failed = drv.check(registry.reference(spec["config_name"]),
                               spec["mix"]["limits"])
    correct = all(math.isfinite(v) and v <= limit for _, v, limit in checks)

    ctx = Context(setup_s, window_s, steps,
                  dict(sp.counts) if sp else {},
                  dict(sp.records) if sp else {}, got, spec["config"], mix,
                  step_s, traced,
                  steps - spanned if spanned is not None else 0)
    metrics = {}
    for name in spec["per_layer" if trace else "end_to_end"]:
        value = registry.metric_reader(name)(ctx)
        if value is not None:
            metrics[name] = {"value": float(value),
                             "unit": spec["units"][name]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": spec["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": drv.answered(),
              "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = got.busy_s if got else 0.0
        dev["window_s"] = got.window_s if got else 0.0
        if got:
            result["breakdown"] = {"device_ops": got.device_ops,
                                   "idle_gaps": got.idle_gaps}
    result["checks"] = {name: {"value": v, "limit": limit}
                        for name, v, limit in checks}
    return result, step_s
