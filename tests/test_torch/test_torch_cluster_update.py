"""quimb_torch's ``experimental/cluster_update.py`` against quimb_tpu's, on
the CPU in float64, from the same arrays: ``fit_bondenv_projectors``
(``Pl @ Pr`` at 1e-9: an ALS of small solves whose iterates are equivariant
under the gauge of the initial SVD) and ``ClusterUpdateGen`` on a small
kagome lattice (D=2, the energy per site at 1e-10 relative after one step).
quimb_tpu's side runs on host arrays inside its ``contract_backend
("numpy")``."""

import numpy as np
import pytest
import torch

import quimb_torch.experimental as tex
import quimb_torch.tensor as ttn
import quimb_tpu.experimental as jex
import quimb_tpu.tensor as jtn
from quimb_torch import convert
from quimb_tpu.ops.contraction import contract_backend


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env(D, seed, dtype):
    """A positive bond environment E[kl, kr, bl, br] = X X^H over the
    (ket, bra) pairing."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((D * D, D * D + 2))
    if dtype == "complex128":
        X = X + 1j * rng.standard_normal(X.shape)
    return (X @ X.conj().T).reshape(D, D, D, D)


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
@pytest.mark.parametrize("max_bond", [2, 3])
def test_fit_bondenv_projectors_match(max_bond, dtype):
    E = _env(4, max_bond, dtype)
    with contract_backend("numpy"):
        Plj, sj, Prj = jex.fit_bondenv_projectors(E, max_bond,
                                                  max_iterations=20)
    before = dict(tex.cluster_update.HOST_READS)
    Plt, st, Prt = tex.fit_bondenv_projectors(torch.as_tensor(E), max_bond,
                                              max_iterations=20)
    want = np.asarray(Plj) @ np.asarray(Prj)
    got = (Plt @ Prt).numpy()
    assert Plt.shape == (4, max_bond) and Prt.shape == (max_bond, 4)
    assert np.linalg.norm(got - want) <= 1e-9 * np.linalg.norm(want)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-9)
    # one host read of the cost per ALS iteration, as quimb_tpu's
    assert tex.cluster_update.HOST_READS["als cost"] > before.get(
        "als cost", 0)


@pytest.fixture(scope="module")
def kagome_runs():
    edges = jtn.edges_2d_kagome(2, 2)
    rng = np.random.default_rng(42)
    psi0 = jtn.TN_from_edges_and_fill_fn(
        lambda shape: rng.standard_normal(shape), edges, 2, phys_dim=2)
    tpsi0 = convert.from_tpu_tngen(psi0, device="cpu")
    psi0.apply_to_arrays(np.asarray)
    out = {}
    with contract_backend("numpy"):
        sj = jex.ClusterUpdateGen(psi0, jtn.ham_gen_heis(edges), D=2,
                                  cluster_distance=1, fit_iterations=10,
                                  compute_energy_final=False)
        sj.evolve(1, tau=0.3)
        out["quimb_tpu"] = _energy(sj)
    tex.cluster_update.HOST_READS.clear()
    st = tex.ClusterUpdateGen(tpsi0, ttn.ham_gen_heis(edges), D=2,
                              cluster_distance=1, fit_iterations=10,
                              compute_energy_final=False)
    st.evolve(1, tau=0.3)
    out["reads"] = dict(tex.cluster_update.HOST_READS)
    out["quimb_torch"] = _energy(st)
    out["gates"] = len(edges)
    out["state"] = st
    return out


def _energy(su):
    gauges = {}
    tn = su.get_state().gauge_all_simple(max_iterations=20, gauges=gauges)
    e = tn.compute_local_expectation(su.ham.terms, method="cluster",
                                     gauges=gauges)
    return float(np.real(e)) / tn.nsites


def test_cluster_update_energy_matches(kagome_runs):
    want, got = kagome_runs["quimb_tpu"], kagome_runs["quimb_torch"]
    assert abs(got - want) <= 1e-10 * abs(want)
    st = kagome_runs["state"]
    assert st.compute_energy_opts["max_distance"] == 2
    assert max(t.ind_size(ix) for t in st.state for ix in t.inds
               if ix in st.gauges) <= 2


def test_cluster_update_host_reads(kagome_runs):
    """Two site norms a gate, and one ALS cost an iteration, read to the
    host, as quimb_tpu reads them."""
    reads = kagome_runs["reads"]
    assert reads["site norm"] == 2 * kagome_runs["gates"]
    assert reads["als cost"] >= kagome_runs["gates"]


def test_cluster_sites():
    edges = jtn.edges_2d_kagome(2, 2)
    psi = ttn.TN_from_edges_rand(edges, 2, phys_dim=2, seed=1,
                                 device="cpu")
    su = tex.ClusterUpdateGen(psi, ttn.ham_gen_heis(edges), D=2,
                              cluster_distance=1)
    a, b = edges[0]
    sites = su._cluster_sites(a, b)
    assert {a, b} <= sites
    neighbours = {s for e in edges for s in e if a in e or b in e}
    assert sites == neighbours
