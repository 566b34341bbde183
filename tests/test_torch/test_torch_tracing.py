"""The ranges of ``quimb_torch.tracing`` on the CPU: a null context with no
profiler session; under a ``torch.profiler`` session, the ranges of a DMRG2
sweep and of the restarted Lanczos solver, counted and nested, with results
bit for bit those of a run without a session; and the benchmark's reducer
of a real session's events, whose fields the ranges leave as they were."""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import quimb_torch
from portbench.harness import trace as trace_mod
from quimb_torch import tracing
from quimb_torch.linalg import lanczos as tl
from quimb_torch.tensor.tn1d import dmrg as td

L, CHI = 8, 8


def _profile():
    return profile(activities=[ProfilerActivity.CPU])


def _ranges(prof):
    """The program's ranges of a session: ``{kind: [(start, end), ...]}``."""
    out = {}
    for e in trace_mod.kineto_events(prof, torch):
        if e.name.startswith(tracing.PREFIX):
            out.setdefault(e.name[len(tracing.PREFIX):], []).append(
                (e.start, e.end))
    return out


def _engine():
    ham = quimb_torch.MPO_ham_heis(L, device="cpu")
    p0 = quimb_torch.MPS_rand_state(L, CHI, seed=3, device="cpu")
    return td.DMRG2(ham, bond_dims=CHI, cutoffs=1e-10, p0=p0)


def _sweeps(d, step=contextlib.nullcontext):
    """A right sweep that canonizes, then a left one; their energies."""
    out = []
    for direction in "RL":
        with step():
            out.append(d.sweep(direction, max_bond=CHI, cutoff=1e-10,
                               canonize=direction == "R"))
    return out


def test_span_without_a_session_is_one_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = tracing.span("bond"), tracing.span("sandwich")
    assert a is b
    assert isinstance(a, contextlib.nullcontext)
    with a:
        pass


def test_span_under_a_session_is_a_named_range():
    with _profile() as prof:
        with tracing.span("bond"):
            torch.ones(3).sum()
        tracing.spanned("split")(lambda: torch.ones(2) * 2)()
    assert {k: len(v) for k, v in _ranges(prof).items()} == \
        {"bond": 1, "split": 1}


def test_dmrg2_sweep_ranges_counted_and_nested(monkeypatch):
    absorptions = []
    for name in ("_env_step_right", "_env_step_left"):
        orig = getattr(td, name)

        def counted(*args, _orig=orig):
            absorptions.append(1)
            return _orig(*args)

        monkeypatch.setattr(td, name, counted)
    d = _engine()
    ncv = d._solve_opts()["ncv"]
    with _profile() as prof:
        _sweeps(d)
    r = _ranges(prof)
    bonds = 2 * (L - 1)
    counts = {k: len(v) for k, v in r.items()}
    assert counts == {
        "bond": bonds, "local_solve": bonds, "lanczos_restart": bonds,
        "tridiag": bonds, "split": bonds, "sandwich": bonds * ncv,
        "env_step": len(absorptions), "canonize": 1}
    # a sweep's starting build, L - 2 absorptions, and one a bond
    assert len(absorptions) == 2 * (L - 2) + bonds

    def within(inner, outer):
        return all(any(s0 <= s and e <= e0 for s0, e0 in r[outer])
                   for s, e in r[inner])

    for inner, outer in [("sandwich", "lanczos_restart"),
                         ("lanczos_restart", "local_solve"),
                         ("tridiag", "lanczos_restart"),
                         ("local_solve", "bond"), ("split", "bond")]:
        assert within(inner, outer), (inner, outer)
    # every bond's update ends in its environment step; the starting
    # builds lie outside the bonds
    inside = [any(s0 <= s and e <= e0 for s0, e0 in r["bond"])
              for s, e in r["env_step"]]
    assert sum(inside) == bonds


def test_sweeps_bit_identical_with_and_without_a_session():
    plain, traced = _engine(), _engine()
    e_plain = _sweeps(plain)
    with _profile():
        e_traced = _sweeps(traced)
    assert e_plain == e_traced
    assert all(torch.equal(a, b)
               for x, y in zip(plain.local_energies, traced.local_energies)
               for a, b in zip(x, y))
    assert all(torch.equal(a, b) for a, b in zip(plain._A, traced._A))


@pytest.mark.parametrize("restarts", [1, 3, 8])
def test_eigh_lanczos_one_range_a_restart(monkeypatch, restarts):
    g = torch.Generator().manual_seed(5)
    H = torch.randn(60, 60, generator=g, dtype=torch.float64)
    H = H + H.T
    v0 = torch.randn(60, generator=g, dtype=torch.float64)
    bases = []
    orig = tl._lanczos_basis

    def counted(*args):
        bases.append(1)
        return orig(*args)

    monkeypatch.setattr(tl, "_lanczos_basis", counted)
    lam_plain, v_plain = tl.eigh_lanczos(H, v0, ncv=8, restarts=restarts,
                                         tol=1e-12)
    bases.clear()
    with _profile() as prof:
        lam, v = tl.eigh_lanczos(H, v0, ncv=8, restarts=restarts, tol=1e-12)
    r = _ranges(prof)
    assert len(r["lanczos_restart"]) == len(bases) == restarts
    assert len(r["tridiag"]) == restarts
    assert torch.equal(lam, lam_plain) and torch.equal(v, v_plain)


def test_reducer_keeps_the_program_ranges_out_of_its_fields():
    """The benchmark's reducer, on a real session's events with and
    without the program's ranges: every field it computes, but the names
    of the idle gaps, is the same, and the ranges are host events only."""
    d = _engine()
    with _profile() as prof:
        _sweeps(d, step=lambda: record_function("portbench.step"))
    events = trace_mod.kineto_events(prof, torch)
    program = [e for e in events if e.name.startswith(tracing.PREFIX)]
    assert not any(e.device for e in program)
    assert sum(e.name == tracing.PREFIX + "bond" for e in program) == \
        2 * (L - 1)
    spanned = trace_mod.reduce(events)
    plain = trace_mod.reduce([e for e in events if e not in program])
    assert spanned.window_s > 0
    for name in ("window_s", "busy_s", "n_device", "span_device_s",
                 "span_counts", "d2h_copies", "sync_calls", "device_ops"):
        assert getattr(spanned, name) == getattr(plain, name), name
    assert sum(s for _, s in spanned.idle_gaps) == \
        sum(s for _, s in plain.idle_gaps)
