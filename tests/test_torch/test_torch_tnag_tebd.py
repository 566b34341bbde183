"""quimb_torch's arbitrary-geometry TEBD (``tensor/tnag/tebd.py``:
``LocalHamGen``, ``ham_gen_heis``, ``TEBDGen``, ``SimpleUpdateGen``)
against quimb_tpu's, in float64 on the CPU.

Both packages start from one state, built in quimb_tpu from a numpy fill
function and carried across by ``convert.from_tpu_tngen``. An evolution is
a few dozen reduce-split gates with a cutoff; its energies agree to 1e-10.
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
LATTICES = {
    "square 2x2": ttn.edges_2d_square(2, 2),
    "kagome 2x2 cells": ttn.edges_2d_kagome(2, 2),
}


@pytest.fixture(autouse=True)
def _one_thread_host_reference():
    """One torch thread (small splits, which threads only slow down on a
    shared host), and quimb_tpu on host numpy arrays (its
    ``contract_backend("numpy")``: no XLA dispatch of tiny operations)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with jbackend("numpy"):
        yield
    torch.set_num_threads(n)


def _pair(edges, D=2, seed=0):
    rng = np.random.default_rng(seed)
    j = jtn.TN_from_edges_and_fill_fn(lambda s: rng.normal(size=s), edges, D,
                                      phys_dim=2)
    return j, convert.from_tpu_tngen(j, device=CPU)


def test_local_ham_gen_matches():
    edges = LATTICES["kagome 2x2 cells"]
    hj, ht = jtn.ham_gen_heis(edges, j=0.8, bz=0.3), \
        ttn.ham_gen_heis(edges, j=0.8, bz=0.3)
    assert ht.sites == hj.sites and ht.nsites == hj.nsites
    assert list(ht.terms) == list(hj.terms)
    for k in hj.terms:
        np.testing.assert_allclose(ht.get_gate(k), np.asarray(hj.terms[k]),
                                   rtol=0, atol=1e-14)
        np.testing.assert_allclose(ht.get_term(k[::-1]), ht.terms[k])
    where = edges[0]
    for x in (-0.1, -0.05j):
        U = ht.get_gate_expm(where, x)
        np.testing.assert_allclose(U, np.asarray(hj.get_gate_expm(where, x)),
                                   rtol=0, atol=1e-13)
        np.testing.assert_allclose(U, sla.expm(x * ht.get_term(where)),
                                   rtol=0, atol=1e-13)
        assert ht.get_gate_expm(where, x) is U
    assert np.isrealobj(ht.get_gate_expm(where, -0.1))
    assert ht.get_auto_ordering() == hj.get_auto_ordering()
    assert ht.get_auto_ordering("colors") == hj.get_auto_ordering("colors")
    ht.apply_to_arrays(lambda a: 2 * a)
    np.testing.assert_allclose(ht.terms[where], 2 * np.asarray(
        hj.terms[where]))
    assert not ht._gate_cache


def test_one_site_terms():
    """A dict of one-site terms is shared among each site's bonds, as in
    quimb_tpu; one array is every site's term (quimb_tpu drops it)."""
    edges = LATTICES["square 2x2"]
    h2 = np.kron(np.diag([1.0, -1.0]), np.diag([1.0, -1.0]))
    x = np.array([[0.0, 1.0], [1.0, 0.0]])
    sites = sorted({s for e in edges for s in e})
    H1 = {s: 0.3 * x for s in sites}
    hj = jtn.LocalHamGen({e: h2 for e in edges}, H1)
    ht = ttn.LocalHamGen({e: h2 for e in edges}, H1)
    for k in hj.terms:
        np.testing.assert_allclose(ht.terms[k], np.asarray(hj.terms[k]),
                                   rtol=0, atol=1e-15)
    one = ttn.LocalHamGen({e: h2 for e in edges}, 0.3 * x)
    for k in ht.terms:
        np.testing.assert_allclose(one.terms[k], ht.terms[k], rtol=0,
                                   atol=1e-15)


@pytest.mark.parametrize("lattice", list(LATTICES))
@pytest.mark.parametrize("cls", ["TEBDGen", "SimpleUpdateGen"])
def test_evolution_matches(cls, lattice):
    edges = LATTICES[lattice]
    j, t = _pair(edges, seed=1)
    hj, ht = jtn.ham_gen_heis(edges), ttn.ham_gen_heis(edges)
    ej = getattr(jtn, cls)(j, hj, D=2)
    et = getattr(ttn, cls)(t, ht, D=2)
    for tau in (0.3, 0.1):
        ej.evolve(2, tau=tau)
        et.evolve(2, tau=tau)
    np.testing.assert_allclose(et.energies, ej.energies, rtol=0, atol=1e-10)
    assert et.its == ej.its and et.taus == ej.taus
    assert et.n == 4 and len(et.energies) == 2
    assert all(x.data.device.type == "cpu" for x in et.state)
    psi = et.get_state()
    np.testing.assert_allclose(np.asarray(psi.to_dense()),
                               np.asarray(ej.get_state().to_dense()),
                               rtol=0, atol=1e-10)
    if cls == "SimpleUpdateGen":
        assert set(et.gauges) == set(ej.gauges)
        for ix in ej.gauges:
            np.testing.assert_allclose(et.gauges[ix].numpy(),
                                       np.asarray(ej.gauges[ix]), rtol=0,
                                       atol=1e-10)
    data = et.assemble_plot_data()
    assert data["energies"] == et.energies


def test_exact_energy_option_matches():
    edges = LATTICES["square 2x2"]
    j, t = _pair(edges, seed=2)
    hj, ht = jtn.ham_gen_heis(edges), ttn.ham_gen_heis(edges)
    opts = {"method": "exact"}
    ej = jtn.SimpleUpdateGen(j, hj, D=2, compute_energy_opts=opts)
    et = ttn.SimpleUpdateGen(t, ht, D=2, compute_energy_opts=opts)
    ej.evolve(3, tau=0.2)
    et.evolve(3, tau=0.2)
    assert et.energy == pytest.approx(ej.energy, abs=1e-10)
    psi = et.get_state()
    v = np.asarray(psi.to_dense()).reshape(-1)
    H = sum(_embed(ht.get_term(e), e, psi.sites) for e in edges)
    assert et.energy == pytest.approx(v @ H @ v / (v @ v), abs=1e-10)


def _embed(h, edge, sites):
    """The two-site term ``h`` on ``edge`` as a dense operator on
    ``sites``."""
    n = len(sites)
    a, b = (sites.index(s) for s in edge)
    op = np.einsum(np.asarray(h).reshape(2, 2, 2, 2), [0, 1, 2, 3],
                   np.eye(2 ** (n - 2)).reshape([2] * (2 * n - 4)),
                   list(range(4, 2 * n)))
    others = [q for q in range(n) if q not in (a, b)]
    out, inn = [None] * n, [None] * n
    out[a], out[b], inn[a], inn[b] = 0, 1, 2, 3
    for k, q in enumerate(others):
        out[q], inn[q] = 4 + k, 4 + len(others) + k
    return np.transpose(op, out + inn).reshape(2 ** n, 2 ** n)
