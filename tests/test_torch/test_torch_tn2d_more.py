"""The rest of quimb_torch's 2D layer against quimb_tpu's, in float64 on
the CPU: HOTRG and CTMRG contractions, HOTRG coarse-graining, the
``"full-bond"`` boundary mode, and FullUpdate with its ALS and autodiff
fits.

A PEPS crosses from quimb_tpu with ``convert.from_tpu_peps``; quimb_tpu's
side runs on host arrays inside its ``contract_backend("numpy")``, so no
test waits on XLA compiles (see ``test_torch_tn2d.py``).
"""

import functools

import numpy as np
import pytest
import torch

import quimb_tpu.tensor as jtn
import quimb_torch.tensor as ttn
from quimb_torch import convert
from quimb_torch.tensor.tn2d import core as tcore
from quimb_tpu.ops.contraction import contract_backend as jbackend

CPU = "cpu"
# float64 boundary sweeps and merges of a few hundred QR / SVD steps
TOL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: hundreds of tiny factorizations, which threads
    only slow down on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(L, D=2, seed=2):
    """quimb_tpu's ``PEPS_rand`` (float64) and the port's copy of it."""
    j = jtn.PEPS_rand(L, L, D, seed=seed, dtype="float64")
    return j, convert.from_tpu_peps(j, device=CPU)


def _host(tn):
    tn = tn.copy()
    tn.apply_to_arrays(np.asarray)
    return tn


def _f(x):
    return float(np.real(complex(x)))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


@functools.lru_cache(maxsize=None)
def _exact_norm(L, D=2, seed=2):
    j, _ = _pair(L, D, seed)
    return float(np.linalg.norm(np.asarray(j.to_dense())) ** 2)


@pytest.mark.parametrize("name,exact_tol", [("contract_hotrg", 1e-12),
                                            ("contract_ctmrg", 1e-5)])
def test_hotrg_and_ctmrg_match(name, exact_tol):
    """The 4 x 4 norm (D=2) at max_bond 32: the port's value equals
    quimb_tpu's (1e-10) and the exact norm (HOTRG's merges keep every
    value at this size; CTMRG's boundaries truncate at the cutoff 1e-10,
    2e-6 relative here). The in-place form leaves one scalar tensor."""
    j, t = _pair(4)
    with jbackend("numpy"):
        want = _f(getattr(_host(j.make_norm()), name)(max_bond=32))
    got = _f(getattr(t.make_norm(), name)(max_bond=32))
    assert _rel(got, want) < TOL
    assert _rel(got, _exact_norm(4)) < exact_tol
    norm = t.make_norm()
    getattr(norm, name + "_")(max_bond=32)
    assert norm.num_tensors == 1
    assert _rel(_f(norm.contract(...)), got) < TOL


@pytest.mark.parametrize("L,direction,max_bond", [(4, "x", 8), (4, "y", 8),
                                                  (3, "x", 4), (3, "y", 4)])
def test_coarse_grain_hotrg(L, direction, max_bond):
    """One coarse-graining step: the lattice halves along ``direction``
    (an odd row or column left unpaired, its layers not merged and its
    bonds not truncated), the merged bonds truncate to ``max_bond``, and
    the contracted value equals quimb_tpu's (1e-10)."""
    j, t = _pair(L)
    with jbackend("numpy"):
        jc = _host(j.make_norm()).coarse_grain_hotrg(direction,
                                                     max_bond=max_bond)
        want = _f(jc.contract(...))
    tc_ = t.make_norm().coarse_grain_hotrg(direction, max_bond=max_bond)
    assert (tc_.Lx, tc_.Ly) == (jc.Lx, jc.Ly)
    assert tc_.num_tensors == jc.num_tensors
    assert tc_.max_bond() <= max(max_bond, 4)
    assert _rel(_f(tc_.contract(...)), want) < TOL


@pytest.mark.parametrize("mode", ["mps", "projector2d", "full-bond"])
def test_all_modes_4x4_norm_vs_exact(mode):
    """Every boundary mode at max_bond 32 reaches the exact 4 x 4 norm
    (quimb_tpu's ``TestBoundaryModes`` bound, 1e-8)."""
    _, t = _pair(4)
    val = _f(t.make_norm().contract_boundary(max_bond=32, mode=mode))
    assert _rel(val, _exact_norm(4)) < 1e-8


@pytest.mark.parametrize("sequence", [("xmin",), ("ymax",)])
def test_full_bond_truncating_matches(sequence):
    """"full-bond" at max_bond 4 (every new bond of 8 or 16 compressed
    against its environment) equals quimb_tpu's value (1e-10), from each
    side."""
    j, t = _pair(4)
    kw = dict(max_bond=4, mode="full-bond", sequence=sequence)
    with jbackend("numpy"):
        want = _f(_host(j.make_norm()).contract_boundary(**kw))
    got = _f(t.make_norm().contract_boundary(**kw))
    assert _rel(got, want) < TOL
    assert _rel(got, _exact_norm(4)) < 1e-2


def test_full_bond_reuses_opposite_envs(monkeypatch):
    """The opposite-direction environments are computed once per
    contraction and reused for every row."""
    _, t = _pair(4)
    calls = []
    envs = tcore.TensorNetwork2D.compute_x_environments

    def counted(self, *args, **kwargs):
        calls.append(1)
        return envs(self, *args, **kwargs)

    monkeypatch.setattr(tcore.TensorNetwork2D, "compute_x_environments",
                        counted)
    t.make_norm().contract_boundary(max_bond=4, mode="full-bond")
    assert len(calls) == 1


# -- FullUpdate ---------------------------------------------------------------


def _fu_kw(**kw):
    return dict(D=2, chi=16, compute_energy_final=False, **kw)


@pytest.mark.parametrize("L,schedule", [(2, ((4, 0.3), (4, 0.1))),
                                        (3, ((1, 0.3),))])
def test_full_update_als_matches(L, schedule):
    """FullUpdate (ALS) of the Heisenberg model from the same start, on
    the port and on quimb_tpu: the energy after each stage of the schedule
    agrees to 1e-10 (float64 normal equations and boundary contractions,
    round-off)."""
    j, t = _pair(L, seed=7)
    with jbackend("numpy"):
        jfu = jtn.FullUpdate(_host(j), jtn.ham_2d_heis(L, L), **_fu_kw())
        want = []
        for steps, tau in schedule:
            jfu.evolve(steps, tau=tau)
            want.append(_f(jfu.compute_energy()))
    tfu = ttn.FullUpdate(t, ttn.ham_2d_heis(L, L), **_fu_kw())
    for (steps, tau), w in zip(schedule, want):
        tfu.evolve(steps, tau=tau)
        assert _rel(tfu.compute_energy(), w) < TOL


@functools.lru_cache(maxsize=None)
def _anneal(strategy, every=1):
    """quimb_tpu's own anneal test (2 x 2, D=2, chi=16, 10 steps at 0.3,
    12 at 0.1, 12 at 0.01) on the port, from quimb_tpu's start."""
    _, t = _pair(2, seed=7)
    fu = ttn.FullUpdate(t, ttn.ham_2d_heis(2, 2), **_fu_kw(
        fit_strategy=strategy, compute_envs_every=every))
    for steps, tau in ((10, 0.3), (12, 0.1), (12, 0.01)):
        fu.evolve(steps, tau=tau)
    return fu.compute_energy()


def test_autodiff_matches_als():
    """The autodiff fit (L-BFGS with torch.autograd) reaches the ALS
    anneal's energy within quimb_tpu's own 2e-3; both go below the start's
    energy by far."""
    als, ad = _anneal("als"), _anneal("autodiff")
    assert ad == pytest.approx(als, abs=2e-3)
    assert als < -1.8


def test_compute_envs_every(monkeypatch):
    """Reusing the environments for 4 gates stays within quimb_tpu's 5e-3
    of fresh ones; while the bonds keep their sizes the environments are
    recomputed on one gate in four."""
    assert _anneal("als", 4) == pytest.approx(_anneal("als"), abs=5e-3)
    _, t = _pair(2, seed=7)
    fu = ttn.FullUpdate(t, ttn.ham_2d_heis(2, 2),
                        **_fu_kw(compute_envs_every=4))
    fu.evolve(1, tau=0.3)
    calls = []
    envs = tcore.TensorNetwork2D.compute_x_environments

    def counted(self, *args, **kwargs):
        calls.append(1)
        return envs(self, *args, **kwargs)

    monkeypatch.setattr(tcore.TensorNetwork2D, "compute_x_environments",
                        counted)
    fu.evolve(2, tau=0.3)
    assert len(calls) == 2


def test_invalid_strategy_raises():
    _, t = _pair(2)
    with pytest.raises(ValueError):
        ttn.FullUpdate(t, ttn.ham_2d_heis(2, 2), D=2, fit_strategy="bogus")


def test_full_bond_on_one_column():
    """A single column has no boundary bond: ``contract_boundary`` in
    "full-bond" mode returns its exact value, and ``contract_boundary_from``
    refuses it (quimb_tpu's absorbs the last row into a scalar and leaves
    an empty network)."""
    j = jtn.PEPS_rand(3, 1, 2, seed=1, dtype="float64")
    t = convert.from_tpu_peps(j, device=CPU)
    exact = float(np.linalg.norm(np.asarray(j.to_dense())) ** 2)
    val = _f(t.make_norm().contract_boundary(max_bond=4, mode="full-bond"))
    assert _rel(val, exact) < 1e-12
    with pytest.raises(ValueError, match="one column"):
        t.make_norm().contract_boundary_from("xmin", max_bond=4,
                                             mode="full-bond")
