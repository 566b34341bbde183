"""TEBD's ``dt=``, ``queue=`` and ``progbar=``, DMRG's ``verbosity=``,
``suppress_warnings=`` and ``get_default_opts(cyclic=)``, and
``DMRGError``: the keywords ``test_torch_api_parity.py`` found missing
from quimb_torch, against quimb_tpu on the same states, in complex128 /
float64 on the CPU."""

import functools

import numpy as np
import pytest
import torch

import quimb_tpu.tensor as jtn
import quimb_torch
import quimb_torch.tensor as ttn
from quimb_torch.convert import from_tpu_mpo, from_tpu_mps

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- TEBD's dt=, queue= and progbar= ------------------------------------------


L_TEBD = 12
_OPTS = dict(dt=0.05, split_opts={"max_bond": 64, "cutoff": 1e-12})


def _neel():
    return jtn.MPS_neel_state(L_TEBD).astype("complex128")


def _entropy(psi):
    return float(np.real(psi.entropy(L_TEBD // 2)))


def _keyword_steps(e):
    """``step(dt=)``, then a second-order step of ``sweep(..., dt=,
    queue=)``: the half-chain entropy, ``t`` and ``err``."""
    e.step(order=2, dt=0.02)
    for direction, frac in (("right", 0.5), ("left", 1.0), ("right", 0.5)):
        e.sweep(direction, frac, dt=0.035, queue=True)
    return [_entropy(e.pt), e.t, float(e.err)]


def _long_run(e):
    """The keyword steps, then ``update_to`` and ``at_times`` with progress
    bars (second order): entropies, ``t``, ``err``, ``taus``."""
    out = _keyword_steps(e)
    e.update_to(0.1, order=2, progbar=True)
    out.append(_entropy(e.pt))
    out += [_entropy(p) for p in e.at_times([0.15], order=2, progbar=True)]
    return out + [e.t, float(e.err)], list(e.taus)


@functools.cache
def _quimb_tpu(fused):
    """quimb_tpu's fused long run, or its sequential keyword steps (its
    sequential route runs eagerly: several seconds a step here)."""
    e = jtn.TEBD(_neel(), jtn.ham_1d_heis(L_TEBD), progbar=False,
                 fused=fused, **_OPTS)
    return _long_run(e) if fused else _keyword_steps(e)


def _port(fused):
    return ttn.TEBD(from_tpu_mps(_neel(), device=CPU),
                    quimb_torch.ham_1d_heis(L_TEBD), progbar=False,
                    fused=fused, **_OPTS)


@pytest.mark.parametrize("fused", [True, False])
def test_tebd_dt_queue_and_progbar(fused):
    """A 12-site complex128 quench through ``step(dt=)``, ``sweep(...,
    dt=, queue=)`` and ``update_to`` / ``at_times`` with progress bars, on
    the port's fused and sequential routes. The bond cap 64 holds the
    chain's whole state: the fused route's entropies, ``t`` and ``err``
    equal quimb_tpu's fused run at 1e-10. The sequential route drops each
    split's tail below the cutoff bond by bond and adds its weight to
    ``err`` (in both packages): its keyword steps equal quimb_tpu's
    sequential ones at 1e-10, its long run's entropies and ``t`` the fused
    run's at 1e-8.
    ``step(dt=)`` moves the clock, the error estimate and ``taus`` by its
    ``dt`` while its gates keep the engine's, as in quimb_tpu."""
    t = _port(fused)
    assert t._fused_applicable() == fused
    got, taus = _long_run(t)
    want, jtaus = _quimb_tpu(True)
    if fused:
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    else:
        # all but the two err readings; the sequential splits drop their
        # tails below the cutoff one bond at a time, the fused ones a
        # parity at a time: 7e-9 apart here
        keep = [0, 1, 3, 4, 5]
        np.testing.assert_allclose(np.take(got, keep), np.take(want, keep),
                                   rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(_keyword_steps(_port(False)),
                                   _quimb_tpu(False), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(taus, jtaus, rtol=1e-12)
    assert taus[:2] == [0.02, 0.05]
    assert ttn.TEBD(from_tpu_mps(_neel(), device=CPU),
                    quimb_torch.ham_1d_heis(L_TEBD)).progbar is True


# -- DMRG's bookkeeping keywords and DMRGError --------------------------------


def test_dmrg_keywords_and_error(capsys):
    """``sweep(verbosity=)`` and ``solve(suppress_warnings=)`` change
    nothing but what is printed; the energies equal quimb_tpu's (float64
    Lanczos on one state, 1e-9)."""
    from quimb_torch.tensor.tn1d import dmrg as td
    from quimb_tpu.tensor.tn1d import dmrg as jd

    H = jtn.MPO_ham_heis(8)
    p0 = jtn.MPS_rand_state(8, 8, seed=2)
    j = jtn.DMRG2(H, bond_dims=8, cutoffs=1e-10, p0=p0)
    t = quimb_torch.DMRG2(from_tpu_mpo(H, device=CPU), bond_dims=8,
                          cutoffs=1e-10, p0=from_tpu_mps(p0, device=CPU))
    for d in (j, t):
        d.sweep("R", max_bond=8, cutoff=1e-10, verbosity=2)
    assert t.energies == j.energies == []
    kw = dict(tol=1e-9, max_sweeps=4, verbosity=1, suppress_warnings=False)
    assert t.solve(**kw) == j.solve(**kw)
    np.testing.assert_allclose(t.energies, j.energies, rtol=0, atol=1e-9)
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 2 * len(t.energies)
    assert td.get_default_opts(cyclic=True) == td.get_default_opts()
    assert jd.get_default_opts(True) == jd.get_default_opts(False)
    assert issubclass(td.DMRGError, Exception)
    assert td.DMRGError.__name__ == jd.DMRGError.__name__


