"""quimb_torch's 3D simple update (``tensor/tn3d/tebd.py``: ``LocalHam3D``,
``ham_3d_heis``, ``SimpleUpdate3D``) against quimb_tpu's, in float64 on
the CPU.

Both packages start from one PEPS3D, built in quimb_tpu from a numpy fill
function and carried across by ``convert.from_tpu_tn3d`` (the same bond
names, so the same gauge keys). A step is a few dozen reduce-split gates
and bond SVDs of O(1) numbers, each normalised; the gauges and energies
agree to 1e-10 after a few steps (a gauge carries the rounding of every
split before it).
"""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import quimb_tpu.tensor as jtn
import quimb_torch.tensor as ttn
from quimb_torch import convert
from quimb_tpu.ops.contraction import contract_backend as jbackend

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread_host_reference():
    """One torch thread, and quimb_tpu on host numpy arrays."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with jbackend("numpy"):
        yield
    torch.set_num_threads(n)


def _pair(L=(2, 2, 2), D=2, seed=0):
    rng = np.random.default_rng(seed)
    j = jtn.PEPS3D.from_fill_fn(lambda s: rng.normal(size=s), *L, D)
    j.apply_to_arrays(np.asarray)
    return j, convert.from_tpu_tn3d(j, device=CPU)


@pytest.mark.parametrize("bz", [0.0, 0.4])
def test_ham_3d_heis_matches(bz):
    hj, ht = jtn.ham_3d_heis(2, 2, 3, j=0.7, bz=bz), \
        ttn.ham_3d_heis(2, 2, 3, j=0.7, bz=bz)
    assert list(ht.terms) == list(hj.terms)
    assert ht.nsites == hj.nsites == 12
    for k in hj.terms:
        np.testing.assert_allclose(ht.terms[k], np.asarray(hj.terms[k]),
                                   rtol=0, atol=1e-15)
        np.testing.assert_allclose(ht.get_term(k[::-1]), ht.terms[k])
    assert repr(ht) == repr(hj)


@pytest.mark.parametrize("x", [-0.1, -0.05j, 0.3])
def test_gate_expm_matches(x):
    hj, ht = jtn.ham_3d_heis(2, 1, 2), ttn.ham_3d_heis(2, 1, 2)
    where = next(iter(hj.terms))
    U = ht.get_gate_expm(where, x)
    assert U is ht.get_gate_expm(where, x)
    np.testing.assert_allclose(U, np.asarray(hj.get_gate_expm(where, x)),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(U, sla.expm(x * ht.get_term(where)),
                               rtol=0, atol=1e-13)
    # quimb_tpu exponentiates with a complex factor: a complex gate
    assert U.dtype == np.complex128


def test_local_ham_3d_per_site_terms_match():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(4, 4))
    h2 = X + X.T
    H1 = {(0, 0, 0): np.diag([0.3, -0.3]), None: np.diag([0.1, 0.2])}
    pair = ((0, 0, 0), (0, 0, 1))
    H2 = {None: h2, pair: 2 * h2}
    hj = jtn.tn3d.LocalHam3D(1, 2, 2, H2, H1)
    ht = ttn.LocalHam3D(1, 2, 2, H2, H1)
    for k in hj.terms:
        np.testing.assert_allclose(ht.terms[k], np.asarray(hj.terms[k]),
                                   rtol=0, atol=1e-15)


@pytest.mark.parametrize("L, D, steps", [((2, 2, 2), 2, 3),
                                         ((1, 2, 3), 3, 2)])
def test_simple_update_matches(L, D, steps):
    j, t = _pair(L, D, seed=1)
    hj, ht = jtn.ham_3d_heis(*L), ttn.ham_3d_heis(*L)
    suj = jtn.SimpleUpdate3D(j, hj, D=D)
    sut = ttn.SimpleUpdate3D(t, ht, D=D)
    for tau in (0.3, 0.1):
        suj.evolve(steps, tau)
        sut.evolve(steps, tau)
    assert sut.n == suj.n == 2 * steps
    assert set(sut.gauges) == set(suj.gauges)
    for ix, s in suj.gauges.items():
        np.testing.assert_allclose(sut.gauges[ix].numpy(), np.asarray(s),
                                   rtol=0, atol=1e-10)
    # the states, as dense vectors: a bond's splits may pick other signs
    # of its singular vectors in the two packages, which cancel there
    for absorb in (True, False):
        pj, pt = suj.get_state(absorb), sut.get_state(absorb)
        assert pt.dtype == torch.complex128
        np.testing.assert_allclose(pt.to_dense().numpy(),
                                   np.asarray(pj.to_dense()), rtol=0,
                                   atol=1e-10)
    psi = sut.get_state()
    e = psi.compute_local_expectation(ht.terms, max_bond=8)
    ej = suj.get_state().compute_local_expectation(hj.terms, max_bond=8)
    assert complex(e) == pytest.approx(complex(ej), rel=1e-10)


def test_simple_update_gate_reads_each_norm_once(monkeypatch):
    """Each gate reads the norms of its two site tensors to the host, as
    quimb_tpu's does (the count the card's phase reports)."""
    _, t = _pair((1, 1, 2), 2, seed=2)
    ham = ttn.ham_3d_heis(1, 1, 2)
    su = ttn.SimpleUpdate3D(t, ham, D=2)
    reads = []
    orig = ttn.Tensor.norm

    def norm(self):
        reads.append(1)
        return orig(self)

    monkeypatch.setattr(ttn.Tensor, "norm", norm)
    su.evolve(1, 0.1)
    assert len(reads) == 2 * len(ham.terms)
