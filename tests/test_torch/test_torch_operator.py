"""quimb_torch's ``operator`` package against quimb_tpu's, on the CPU: the
Hilbert spaces and their sectors, the term builder (terms, transforms,
coupling maps, host matrices, MPOs, local Hamiltonians), the matrix-free
``CoupledHam`` in every symmetry (none, Z2, U1, U1U1, a 40-site U1 sector),
the models, the nearest-neighbour PEPO, and the slice as a whole:
``heisenberg_from_edges`` -> ``build_coupled_ham`` -> ``groundenergy``.
float64 / complex128 on both sides; a model crosses as one builder
(``convert.from_tpu_operator_builder``). Matvecs agree to rounding: 1e-12
absolute on O(1)-normed inputs unless stated."""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import quimb_tpu.operator as jop
from quimb_tpu.tensor.geometry import edges_2d_square as j_edges_2d_square

import quimb_torch
from quimb_torch import operator as top
from quimb_torch.convert import from_tpu_operator_builder
from quimb_torch.linalg import base_linalg as bl
from quimb_torch.tensor.geometry import edges_2d_square

CPU = "cpu"
#: the exact ground energy of the spin-1/2 Heisenberg antiferromagnet on
#: the 4 x 4 torus (S^z = 0), which quimb_tpu's sector matrix and scipy's
#: eigsh reproduce
E_4X4 = -11.228483208428864


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _chain(n, cyclic=True):
    return [(i, (i + 1) % n) for i in range(n if cyclic else n - 1)]


SECTORS = [(None, None), ("Z2", 0), ("Z2", 1), ("U1", 3), ("U1", 4),
           ("U1U1", (2, 1)), ("U1U1", (1, 3))]


@pytest.mark.parametrize("symmetry,sector", SECTORS)
def test_hilbert_space_matches(symmetry, sector):
    j = jop.HilbertSpace(8, symmetry=symmetry, sector=sector)
    t = top.HilbertSpace(8, symmetry=symmetry, sector=sector)
    assert (t.size, t.nsites, t.symmetry, t.sector) == (
        j.size, j.nsites, j.symmetry, j.sector)
    np.testing.assert_array_equal(t.get_configs(), j.get_configs())
    cs = t.get_configs()
    np.testing.assert_array_equal(t.rank(cs), np.arange(t.size))
    np.testing.assert_array_equal(t.rank(np.arange(256)),
                                  j.rank(np.arange(256)))
    np.testing.assert_array_equal(t.unrank([0, t.size - 1]),
                                  j.unrank([0, j.size - 1]))
    assert t.rand_config(seed=3) == j.rand_config(seed=3)
    r = t.rand_rank(seed=5)
    assert r == j.rand_rank(seed=5)
    assert t.config_to_rank(t.rank_to_config(r)) == r
    np.testing.assert_array_equal(t.rank_to_flatconfig(r),
                                  j.rank_to_flatconfig(r))
    mask = t.get_sector_numba()(np.arange(256))
    np.testing.assert_array_equal(mask, j.get_sector_numba()(np.arange(256)))
    assert repr(t) == repr(j)


def test_hilbert_space_sites_and_ordering():
    edges = [("a", "b"), ("b", "c"), ("c", "a")]
    j = jop.HilbertSpace.from_edges(edges, order=("c", "a", "b"))
    t = top.HilbertSpace.from_edges(edges, order=("c", "a", "b"))
    assert t.sites == j.sites == ("c", "a", "b")
    assert [t.site_to_reg(s) for s in "abc"] == [j.site_to_reg(s)
                                                 for s in "abc"]
    assert t.get_size(sector=1, symmetry="U1") == 3
    np.testing.assert_array_equal(t.get_pascal_table(), j.get_pascal_table())
    with pytest.raises(ValueError):
        t.set_ordering(("a", "b"))


def _rich_builder():
    """A quimb_tpu builder with every kind of term: named spin, Pauli and
    ladder operators, fermionic ones, an explicit matrix, repeated sites
    and a constant, on a space with a custom site order."""
    hs = jop.HilbertSpace(range(6))
    hs.set_ordering((2, 0, 1, 3, 5, 4))
    b = jop.SparseOperatorBuilder(hilbert_space=hs)
    rng = np.random.default_rng(3)
    for i in range(5):
        b += rng.normal(), ("sx", i), ("sx", i + 1)
        b += rng.normal(), ("+", i), ("-", i + 1)
        b += rng.normal(), ("n", i), ("Z", i + 1), ("h", (i + 3) % 6)
    b += 0.3, ("cdag", 0), ("c", 4)
    b += 0.3, ("cdag", 4), ("c", 0)
    b += 0.7, (np.array([[0.2, 0.0], [0.0, -0.4]]), 3)
    b += 0.4, ("sz", 2), ("sz", 2)
    b += -0.2, ("y", 1), ("y", 3)
    return b


def test_builder_terms_matrices_and_transforms():
    j = _rich_builder()
    t = from_tpu_operator_builder(j)
    for jw, pd in ((False, False), (True, False), (False, True),
                   (True, True)):
        if jw != j._transform_jordan_wigner:
            j.jordan_wigner_transform()
            t.jordan_wigner_transform()
        if pd != bool(j._transform_pauli_decompose):
            j.pauli_decompose()
            t.pauli_decompose()
        assert len(t.terms) == len(j.terms)
        assert {ops: c for c, ops in t.terms} == pytest.approx(
            {ops: c for c, ops in j.terms}, abs=1e-14)
        assert (t.nterms, t.locality, t.iscomplex, t.get_dtype()) == (
            j.nterms, j.locality, j.iscomplex, j.get_dtype())
        Ht, Hj = t.build_sparse_matrix(), j.build_sparse_matrix()
        np.testing.assert_allclose(Ht.toarray(), Hj.toarray(), rtol=0,
                                   atol=1e-14)
        for a, b in zip(t.build_coo_data(), j.build_coo_data()):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(
        _np(t.build_matrix_ikron(device=CPU)), np.asarray(
            j.build_matrix_ikron()), rtol=0, atol=1e-13)
    for (ct, st, ft, mt), (cj, sj, fj, mj) in zip(t.build_coupling_map(),
                                                  j.build_coupling_map()):
        assert (ct, st, ft) == (cj, sj, fj)
        np.testing.assert_array_equal(np.asarray(mt), np.asarray(mj))
    # the Pauli decomposition leaves a constant term, which has no local
    # array
    j.pauli_decompose(False)
    t.pauli_decompose(False)
    lt, lj = t.build_local_terms(), j.build_local_terms()
    assert lt.keys() == lj.keys()
    for k in lt:
        np.testing.assert_allclose(lt[k], lj[k], atol=1e-14)
    x = np.random.default_rng(0).standard_normal(2**6)
    np.testing.assert_allclose(t.aslinearoperator() @ x,
                               j.aslinearoperator() @ x, atol=1e-13)
    fc = np.array([1, 0, 1, 1, 0, 0], np.uint8)
    (ct, vt), (cj, vj) = t.flatconfig_coupling(fc), j.flatconfig_coupling(fc)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_allclose(vt, vj, atol=1e-14)
    assert t.config_coupling({s: 1 for s in range(6)})[0] == \
        j.config_coupling({s: 1 for s in range(6)})[0]
    amp = lambda fc: 1.0 + 0.1 * float(np.dot(fc, np.arange(6)))  # noqa
    assert t.evaluate_exact_flatconfigs(amp) == pytest.approx(
        j.evaluate_exact_flatconfigs(amp), abs=1e-12)
    amp_c = lambda c: 1.0 + 0.2 * c[1] - 0.1 * c[4]  # noqa: E731
    assert t.evaluate_exact_configs(amp_c) == pytest.approx(
        j.evaluate_exact_configs(amp_c), abs=1e-12)
    np.testing.assert_array_equal(top.get_mat("sy"), jop.get_mat("sy"))
    assert repr(t) == repr(j).replace("quimb_tpu", "quimb_torch")
    # the state machine's text rendering: quimb_tpu's, line for line
    import contextlib
    import io

    outs = []
    for b in (t, j):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            trans = b.draw_state_machine()
        outs.append((buf.getvalue(), [sorted(tr) for tr in trans]))
    assert outs[0] == outs[1] and outs[0][0]


def _matvec_check(b_j, dtype="float64", complex_x=False, seed=42):
    """The port's CoupledHam of quimb_tpu's builder against quimb_tpu's
    sector matrix: one vector and a block of three columns."""
    b = from_tpu_operator_builder(b_j)
    H = b_j.build_sparse_matrix()
    op = b.build_coupled_ham(dtype=dtype, device=CPU)
    assert op.shape == H.shape and op.configs.dtype == torch.int64
    assert op.configs.ndim == 1
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((H.shape[0], 3))
    if complex_x:
        x = x + 1j * rng.standard_normal(x.shape)
    X = torch.as_tensor(x)
    np.testing.assert_allclose(_np(op @ X[:, 0]), H @ x[:, 0], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(_np(op @ X), H @ x, rtol=0, atol=1e-12)
    np.testing.assert_allclose(_np((op @ X[:, :1])[:, 0]), H @ x[:, 0],
                               atol=1e-12)
    return op, H


@pytest.mark.parametrize("symmetry,sector", SECTORS)
def test_coupled_ham_every_symmetry(symmetry, sector):
    hs = jop.HilbertSpace(8, symmetry=symmetry, sector=sector)
    b = jop.heisenberg_from_edges(_chain(8), j=(1.0, 0.6, 0.3), b=0.2,
                                  hilbert_space=hs)
    op, H = _matvec_check(b)
    np.testing.assert_allclose(_np(op.to_dense()), H.toarray(), atol=1e-12)


@pytest.mark.parametrize("symmetry,sector", [(None, None), ("Z2", 1)])
def test_coupled_ham_tfim_parity_terms(symmetry, sector):
    """Single-X terms leave a Z2 sector: their in-sector block is zero."""
    hs = jop.HilbertSpace(7, symmetry=symmetry, sector=sector)
    b = jop.SparseOperatorBuilder(hilbert_space=hs)
    for i in range(6):
        b += -1.0, ("Z", i), ("Z", i + 1)
    for i in range(7):
        b += -0.7, ("X", i)
        b += 0.1, ("X", i), ("X", (i + 2) % 7)
    _matvec_check(b)


def test_coupled_ham_complex_and_real_part_after_product():
    """A complex operator in complex128 against the sector matrix; y (x) y
    (imaginary factors, a real product) and a truly complex operator in
    float64 against quimb_tpu's own CoupledHam, which takes the real part
    after the product."""
    b = jop.rand_operator(7, 24, 3, kmin=1, seed=5)
    b.pauli_decompose()
    assert b.iscomplex
    _matvec_check(b, dtype="complex128", complex_x=True)
    hs = jop.HilbertSpace(6, symmetry="U1", sector=3)
    byy = jop.SparseOperatorBuilder(hilbert_space=hs)
    for i in range(5):
        byy += 0.5, ("sy", i), ("sy", i + 1)
        byy += 0.2, ("sx", i), ("sx", i + 1)
    _matvec_check(byy)
    x = np.random.default_rng(1).standard_normal(2**5)
    bj = jop.rand_operator(5, 12, 2, seed=8, ops="XY")
    assert bj.iscomplex
    want = np.asarray(bj.build_coupled_ham(dtype="float64") @ x)
    got = from_tpu_operator_builder(bj).build_coupled_ham(
        dtype="float64", device=CPU) @ torch.as_tensor(x)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(_np(got), want, atol=1e-12)


def test_coupled_ham_40_sites_two_particles():
    """A 40-site U1 sector of two particles (configurations beyond 31
    bits: quimb_tpu's test_coupled_matvec_u1_40_sites_dual_word)."""
    hs = jop.HilbertSpace(40, symmetry="U1", sector=2)
    b = jop.SparseOperatorBuilder(hilbert_space=hs)
    for i in range(39):
        b += 0.5, ("+", i), ("-", i + 1)
        b += 0.5, ("-", i), ("+", i + 1)
        b += 1.0, ("sz", i), ("sz", i + 1)
    op, H = _matvec_check(b)
    assert H.shape[0] == 40 * 39 // 2
    assert int(op.configs.max()) > 2**31
    hs = jop.HilbertSpace(36, symmetry="U1U1", sector=(1, 2))
    b = jop.heisenberg_from_edges(_chain(36, cyclic=False),
                                  hilbert_space=hs)
    _matvec_check(b)


def test_coupled_ham_limits():
    b = top.SparseOperatorBuilder(
        hilbert_space=top.HilbertSpace(63, symmetry="U1", sector=1))
    b += 1.0, ("sz", 0)
    with pytest.raises(NotImplementedError, match="nsites <= 62"):
        b.build_coupled_ham(device=CPU)
    b = top.SparseOperatorBuilder(
        hilbert_space=top.HilbertSpace(32, symmetry="Z2", sector=0))
    b += 1.0, ("sz", 0)
    with pytest.raises(NotImplementedError, match="U1/U1U1"):
        b.build_coupled_ham(device=CPU)


def test_coupled_ham_chunks_and_constant():
    """Chunks of a single group give the same result as one chunk; a
    constant term shifts the diagonal."""
    hs = jop.HilbertSpace(9, symmetry="U1", sector=4)
    bj = jop.heisenberg_from_edges(_chain(9), hilbert_space=hs)
    b = from_tpu_operator_builder(bj)
    b += 0.75, ("i", 0)
    op = b.build_coupled_ham(device=CPU)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        op.shape[0]))
    want = op @ x
    op.CHUNK_ELEMENTS = 1
    np.testing.assert_allclose(_np(op @ x), _np(want), atol=1e-13)
    np.testing.assert_allclose(
        _np(want), bj.build_sparse_matrix() @ _np(x) + 0.75 * _np(x),
        atol=1e-12)
    assert b.matvec(x).device.type == "cpu"


def test_operator_device_comes_from_the_operator():
    """``groundenergy`` of an operator that carries its device solves
    there; with no device the builder puts it on the GPU, which this CPU
    machine has not."""
    hs = top.HilbertSpace(8, symmetry="U1", sector=4)
    b = top.heisenberg_from_edges(_chain(8), hilbert_space=hs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        b.build_coupled_ham()
    op = b.build_coupled_ham(device=CPU)
    assert bl._as_operator(op)[4] == torch.device("cpu")
    e = quimb_torch.groundenergy(op)
    assert e.device.type == "cpu"
    want = np.linalg.eigvalsh(b.build_sparse_matrix().toarray())[0]
    assert float(e) == pytest.approx(want, abs=1e-10)


def test_slice_4x4_torus():
    """The slice on the 4 x 4 torus: D = 12,870, the ground energy within
    1e-10 relative of the exact value and of quimb_tpu's sector matrix by
    scipy's eigsh."""
    edges = edges_2d_square(4, 4, cyclic=True)
    sites = sorted({s for e in edges for s in e})
    hs = top.HilbertSpace(sites, symmetry="U1", sector=8)
    b = top.heisenberg_from_edges(edges, hilbert_space=hs)
    op = b.build_coupled_ham(dtype="float64", device=CPU)
    assert op.shape[0] == 12870 and op.nterms_by_arity == {2: 96}
    assert op.ngroups == 32  # one hop group a bond; the zz terms diagonal
    e = float(quimb_torch.groundenergy(op))
    assert abs(e - E_4X4) <= 1e-10 * abs(E_4X4)
    jedges = j_edges_2d_square(4, 4, cyclic=True)
    jb = jop.heisenberg_from_edges(jedges, hilbert_space=jop.HilbertSpace(
        sorted({s for e in jedges for s in e}), symmetry="U1", sector=8))
    H = jb.build_sparse_matrix()
    ej = spla.eigsh(H, k=1, which="SA", tol=1e-12, v0=np.random.default_rng(
        42).standard_normal(H.shape[0]), return_eigenvectors=False)[0]
    assert abs(e - ej) <= 1e-10 * abs(ej)


def test_slice_10_site_chain_against_quimb_tpu_coupled_ham():
    """A 10-site U1 ring: the port's CoupledHam route against quimb_tpu's
    CoupledHam route (its matvec, and ``groundenergy`` of it)."""
    import quimb_tpu.linalg.base_linalg as jbl

    hs = jop.HilbertSpace(10, symmetry="U1", sector=5)
    bj = jop.heisenberg_from_edges(_chain(10), hilbert_space=hs)
    jh = bj.build_coupled_ham(dtype="float64")
    op = from_tpu_operator_builder(bj).build_coupled_ham(device=CPU)
    x = np.random.default_rng(4).standard_normal(op.shape[0])
    np.testing.assert_allclose(_np(op @ torch.as_tensor(x)),
                               np.asarray(jh @ x), atol=1e-12)
    ej = float(jbl.groundenergy(jh))
    assert float(quimb_torch.groundenergy(op)) == pytest.approx(ej,
                                                               abs=1e-9)


def test_fermi_hubbard_u1u1_2x3():
    """Spinful Fermi-Hubbard on a 2 x 3 lattice (12 modes), U1U1 sectors,
    against quimb_tpu's sector matrix: matvecs and the ground energy."""
    edges = [(0, 1), (1, 2), (3, 4), (4, 5), (0, 3), (1, 4), (2, 5)]
    for sector in ((3, 3), (2, 4)):
        hs = jop.HilbertSpace(12, symmetry="U1U1", sector=sector)
        bj = jop.fermi_hubbard_from_edges(edges, t=1.0, U=4.0, mu=0.3,
                                          hilbert_space=hs)
        op, H = _matvec_check(bj)
    want = np.linalg.eigvalsh(H.toarray())[0]
    assert float(quimb_torch.groundenergy(op)) == pytest.approx(want,
                                                               abs=1e-9)


def test_models_match():
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)]
    pairs = [
        (jop.fermi_hubbard_spinless_from_edges(edges, t=0.7, V=0.4, mu=0.2),
         top.fermi_hubbard_spinless_from_edges(edges, t=0.7, V=0.4, mu=0.2)),
        (jop.heisenberg_from_edges(edges, j=(1.0, 1.0, 0.5), b=0.3),
         top.heisenberg_from_edges(edges, j=(1.0, 1.0, 0.5), b=0.3)),
        (jop.rand_operator(6, 10, 3, kmin=1, seed=2),
         top.rand_operator(6, 10, 3, kmin=1, seed=2)),
    ]
    for j, t in pairs:
        assert {ops: c for c, ops in t.terms} == pytest.approx(
            {ops: c for c, ops in j.terms}, abs=1e-15)
        np.testing.assert_allclose(t.build_sparse_matrix().toarray(),
                                   j.build_sparse_matrix().toarray(),
                                   atol=1e-14)


def test_build_mpo_local_ham_and_add_mpo():
    """The state-machine MPO (dense, against quimb_tpu's MPO and the
    sparse matrix), its bond dimensions, the LocalHam1D terms and the
    direct sum of two MPOs."""
    from quimb_tpu.tensor.tn1d.core import MatrixProductOperator as JMPO

    bj = jop.SparseOperatorBuilder()
    rng = np.random.default_rng(6)
    for i in range(5):
        bj += rng.normal(), ("sx", i), ("sx", i + 1)
        bj += rng.normal(), ("sz", i), ("sz", i + 1)
        bj += rng.normal(), ("sz", i)
    b = from_tpu_operator_builder(bj)
    mt = b.build_mpo(device=CPU)
    mj = bj.build_mpo()
    assert isinstance(mj, JMPO)
    assert mt.bond_sizes() == mj.bond_sizes()
    dense = _np(mt.to_dense())
    np.testing.assert_allclose(dense, np.asarray(mj.to_dense()), atol=1e-12)
    # the MPO's dense form puts site 0 first, as the builder's ikron form
    np.testing.assert_allclose(dense, np.asarray(bj.build_matrix_ikron()),
                               atol=1e-12)
    lt, lj = b.build_local_ham(), bj.build_local_ham()
    assert lt.terms.keys() == lj.terms.keys()
    for k in lt.terms:
        np.testing.assert_allclose(np.asarray(lt.terms[k]),
                                   np.asarray(lj.terms[k]), atol=1e-14)
    s = top.add_mpo(mt, mt)
    np.testing.assert_allclose(_np(s.to_dense()), 2 * dense, atol=1e-12)
    assert s.bond_sizes() == [2 * d for d in mt.bond_sizes()]


def test_pepo_nearest_neighbor():
    import quimb_tpu.operator.pepobuilder as jpb

    X = np.array([[0, 1], [1, 0]]) / 2
    Z = np.array([[1, 0], [0, -1]]) / 2
    for pairs, C in (([(X, X), (Z, Z)], 0.3 * Z),
                     ([(X, 1j * Z)], None)):
        pt = top.pepo_nearest_neighbor(2, 3, pairs, onsite=C, device=CPU)
        pj = jpb.pepo_nearest_neighbor(2, 3, pairs, onsite=C)
        assert pt.dtype == str(pj.dtype) or str(pt.dtype).endswith(
            str(pj.dtype))
        np.testing.assert_allclose(_np(pt.to_dense()),
                                   np.asarray(pj.to_dense()), atol=1e-12)
    q = top.PEPO_nearest_neighbor(X, X, Z, 2, 2, device=CPU)
    r = jpb.PEPO_nearest_neighbor(X, X, Z, 2, 2)
    np.testing.assert_allclose(_np(q.to_dense()), np.asarray(r.to_dense()),
                               atol=1e-12)
