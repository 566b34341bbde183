"""quimb_torch's exact layer against quimb_tpu's, on the CPU: the spin-chain
Hamiltonians and their local terms, the device operators' matvecs, the
Lanczos ground state, the partial eigensolvers, Krylov ``exp(t A) v`` and
``Evolution``. float64 / complex128 on both sides, inputs from
``np.random.default_rng``. quimb_tpu's operators cross as their scipy
matrices (:func:`quimb_torch.convert.from_tpu_operator`). Eigenvectors
carry an overall phase, so states are compared by their overlap."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import torch

import quimb_torch
import quimb_tpu.core as jcore
import quimb_tpu.evo as jevo
import quimb_tpu.gen.operators as jops
import quimb_tpu.gen.states as jstates
import quimb_tpu.linalg.base_linalg as jbl
import quimb_tpu.linalg.lanczos as jl
from quimb_torch import core
from quimb_torch.convert import from_tpu_operator
from quimb_torch.gen import operators as ops
from quimb_torch.gen import states
from quimb_torch.linalg import base_linalg as bl
from quimb_torch.linalg import lanczos as tl

CPU = "cpu"


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _fidelity(a, b):
    a, b = _np(a).ravel(), _np(b).ravel()
    return abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))


def _rand_herm(rng, n, complex_=True):
    X = rng.standard_normal((n, n))
    if complex_:
        X = X + 1j * rng.standard_normal((n, n))
    return (X + X.conj().T) / 2


# -- operators and states -----------------------------------------------------


HAMS = [
    ("ham_heis", 8, dict()),
    ("ham_heis", 7, dict(j=(1.0, 0.7, 0.3), b=0.4)),
    ("ham_heis", 8, dict(j=0.5, b=(0.1, 0.2, 0.3), cyclic=True)),
    ("ham_ising", 8, dict(jz=1.5, bx=0.7)),
    ("ham_XY", 6, dict(jxy=0.8, bz=0.2, cyclic=True)),
]


@pytest.mark.parametrize("name,n,kw", HAMS)
def test_hamiltonians_match(name, n, kw):
    want = getattr(jops, name)(n, sparse=True, **kw)
    got = getattr(ops, name)(n, sparse=True, **kw)
    assert sp.issparse(got) and got.dtype == want.dtype == np.complex128
    # one scipy assembly, the terms summed in the same order: bitwise
    assert abs(got - want).max() == 0
    dims, terms = getattr(got, core.LOCAL_TERMS_ATTR)
    jdims, jterms = want._quimb_tpu_local_terms
    assert dims == jdims and sorted(terms) == sorted(jterms)
    for key, m in jterms.items():
        np.testing.assert_array_equal(terms[key], m)
    dense = getattr(ops, name)(n, device=CPU, **kw)
    assert dense.dtype == torch.complex128
    np.testing.assert_array_equal(
        dense.numpy(), np.asarray(getattr(jops, name)(n, **kw)))


def test_ham_from_terms_mixed_dims():
    """Random complex one- and two-site terms, neighbouring or not, on
    sites of dimensions 2, 3 and 2."""
    rng = np.random.default_rng(11)
    dims = (2, 3, 2)

    def c(d):
        return rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))

    terms = [(0.7, (c(2), c(3)), (0, 1)), (-1.2, (c(2), c(2)), (2, 0)),
             (0.3, (c(3),), (1,)), (1.1, (c(3), c(2)), (1, 2))]
    want = jcore.ham_from_terms(terms, dims, sparse=True)
    got = core.ham_from_terms(terms, dims, sparse=True)
    assert abs(got - want).max() == 0
    _, gterms = getattr(got, core.LOCAL_TERMS_ATTR)
    for key, m in want._quimb_tpu_local_terms[1].items():
        np.testing.assert_array_equal(gterms[key], m)
    # the local terms applied one by one give the assembled matrix
    lt = core.device_operator(got, device=CPU)
    assert lt.dtype == torch.complex128
    # complex128 sums of at most 4 terms of 12 x 12 products
    np.testing.assert_allclose(lt.to_dense().numpy(), got.toarray(),
                               rtol=0, atol=1e-13)


def test_pauli_and_spin_operators():
    for xyz in "IXYZ":
        np.testing.assert_array_equal(ops.pauli(xyz, device=CPU).numpy(),
                                      np.asarray(jops.pauli(xyz)))
    np.testing.assert_allclose(ops.pauli("x", dim=3, device=CPU).numpy(),
                               np.asarray(jops.pauli("x", dim=3)),
                               rtol=0, atol=1e-15)
    for label in "xyz+-i":
        for S in (0.5, 1.0, 1.5):
            np.testing.assert_array_equal(
                ops.spin_operator(label, S, device=CPU).numpy(),
                np.asarray(jops.spin_operator(label, S)))


@pytest.mark.parametrize("build", [
    lambda m, **kw: m.computational_state("0110101", **kw),
    lambda m, **kw: m.computational_state([1, 0, 0, 1], **kw),
    lambda m, **kw: m.neel_state(7, **kw),
    lambda m, **kw: m.neel_state(6, down_first=True, **kw),
    lambda m, **kw: m.up(**kw),
    lambda m, **kw: m.down(qtype="bra", **kw),
    lambda m, **kw: m.basis_vec(3, 8, **kw),
])
def test_states_match(build):
    got, want = build(states, device=CPU), np.asarray(build(jstates))
    assert got.dtype == torch.complex128 and got.shape == want.shape
    np.testing.assert_array_equal(_np(got), want)


def test_quimbify_and_kron():
    rng = np.random.default_rng(12)
    v = rng.standard_normal(6) + 1j * rng.standard_normal(6)
    for qtype in ("ket", "bra", "dop", None):
        for normalized in (False, True):
            got = core.quimbify(v, qtype=qtype, normalized=normalized,
                                device=CPU)
            want = np.asarray(jcore.quimbify(v, qtype=qtype,
                                             normalized=normalized))
            # a norm or a trace and one division in complex128
            np.testing.assert_allclose(_np(got), want, rtol=1e-15,
                                       atol=1e-15)
    assert core.isket(core.ket(v, device=CPU)) and core.isop(
        core.quimbify(v, qtype="dop", device=CPU))
    a, b = rng.standard_normal((2, 3)), rng.standard_normal((2, 2)) * 1j
    np.testing.assert_array_equal(
        core.kron(torch.as_tensor(a), b).numpy(), np.asarray(jcore.kron(a, b)))
    got = core.kron(sp.csr_matrix(a), b)
    assert sp.issparse(got)
    np.testing.assert_array_equal(got.toarray(),
                                  jcore.kron(sp.csr_matrix(a), b).toarray())
    assert core.prod((2, 3, 4)) == 24
    np.testing.assert_array_equal(_np(core.dag(torch.as_tensor(b))),
                                  np.asarray(jcore.dag(jnp.asarray(b))))


# -- the device operators -----------------------------------------------------


def _skewed_sparse(rng, n=64):
    """A hermitian sparse matrix with one full row and column: its ELL
    padding would take more than 4x its nonzeros, so SparseHam keeps
    COO."""
    A = sp.random(n, n, density=0.02, random_state=np.random.RandomState(
        int(rng.integers(1 << 30))), dtype=float).tolil()
    A[0, :] = rng.standard_normal(n)
    A = A + A.T
    A.setdiag(rng.standard_normal(n))
    return A.tocsr().astype(complex)


@pytest.mark.parametrize("n,kw", [(8, dict()), (9, dict(b=0.3)),
                                  (10, dict()), (8, dict(cyclic=True)),
                                  (8, dict(j=(1.0, 0.0, 0.5), b=(0.4, 0, 0)))])
@pytest.mark.parametrize("complex_vec", [False, True])
def test_device_matvecs(n, kw, complex_vec):
    H = jops.ham_heis(n, sparse=True, **kw)
    Hd = H.toarray()
    rng = np.random.default_rng(13)
    x = rng.standard_normal(2**n)
    if complex_vec:
        x = x + 1j * rng.standard_normal(2**n)
    want_tpu = np.asarray(jcore.device_operator(H).matvec(jnp.asarray(x)))
    want = Hd @ x
    lt = from_tpu_operator(H, device=CPU)
    ell = core.SparseHam(H, device=CPU)
    assert isinstance(lt, core.LocalTermsHam) and ell._ell
    assert lt.dtype == ell.dtype == torch.float64
    for op in (lt, ell):
        got = op.matvec(torch.as_tensor(x)).numpy()
        assert got.dtype == x.dtype
        # float64 sums of at most n + 1 products per entry
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)
        np.testing.assert_allclose(got, want_tpu, rtol=0, atol=1e-12 * scale)
        # a column, and a block of columns
        np.testing.assert_allclose(
            (op @ torch.as_tensor(x)[:, None]).numpy()[:, 0], got, rtol=0,
            atol=1e-12 * scale)
        X = np.stack([x, 2 * x[::-1]], axis=1)
        np.testing.assert_allclose((op @ torch.as_tensor(X)).numpy(), Hd @ X,
                                   rtol=0, atol=1e-11 * scale)
    np.testing.assert_array_equal(ell.to_dense().numpy(), Hd.real)
    np.testing.assert_allclose(lt.to_dense().numpy(), Hd.real, rtol=0,
                               atol=1e-14)


def test_sparse_ham_coo_and_complex():
    rng = np.random.default_rng(14)
    A = _skewed_sparse(rng)
    A = A + 1j * sp.triu(A, 1) - 1j * sp.tril(A, -1)
    x = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    got = core.SparseHam(A, device=CPU)
    want = jcore.SparseHam(A)
    assert not got._ell and not want._ell
    assert got.dtype == torch.complex128
    # complex128 sums of at most 64 products
    np.testing.assert_allclose(got.matvec(torch.as_tensor(x)).numpy(),
                               np.asarray(want.matvec(jnp.asarray(x))),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(got.to_dense().numpy(), A.toarray(), rtol=0,
                               atol=1e-15)
    # a matrix without recorded terms crosses as a SparseHam
    assert isinstance(from_tpu_operator(A, device=CPU), core.SparseHam)


def test_local_terms_cast_once():
    """A complex vector meets the real mats by one cast, cached; the terms
    near the chain's end are one GEMM each, the rest batched products."""
    lt = quimb_torch.device_operator(ops.ham_heis(8, sparse=True),
                                     device=CPU)
    x = torch.ones(256, dtype=torch.complex128)
    lt.matvec(x)
    plan = lt._plan(torch.complex128, 1)
    lt.matvec(x)
    assert lt._plan(torch.complex128, 1) is plan
    assert all(m.dtype == torch.complex128 for _, _, m in plan)
    assert lt.mats[0].dtype == torch.float64
    # post = 2**(6 - i) for the term (i, i + 1): D * post <= 64 from i = 2,
    # and the last two widened to 16 columns by the sites before them
    assert [kind for kind, _, _ in plan] == ["bmm"] * 2 + ["gemm"] * 5
    assert [shape for _, shape, _ in plan[2:]] == [
        (4, 64), (8, 32), (16, 16), (16, 16), (16, 16)]
    # widened on mixed dimensions too: by 3, then by 2, to 24 columns
    lt = core.LocalTermsHam((2, 3, 2, 2), {(2, 3): np.eye(4)}, device=CPU)
    assert lt._plan(torch.float64, 1)[0][1] == (1, 24)


# -- eigensolvers -------------------------------------------------------------


@pytest.mark.parametrize("n", [10, 12])
def test_groundenergy_lanczos(n):
    H = ops.ham_heis(n, sparse=True)
    assert bl.choose_backend(H, 1) == "lanczos"
    want = float(jbl.groundenergy(jops.ham_heis(n, sparse=True)))
    got = quimb_torch.groundenergy(H, device=CPU)
    assert got.dtype == torch.float64 and got.ndim == 0
    # the same start vector and float64 Lanczos, stopped at 1e-10
    assert float(got) == pytest.approx(want, rel=1e-10)
    assert float(got) == pytest.approx(
        sla.eigh(H.toarray(), eigvals_only=True, subset_by_index=(0, 0))[0],
        rel=1e-10)
    psi = quimb_torch.groundstate(H, device=CPU)
    assert psi.shape == (2**n, 1)
    assert _fidelity(psi, jbl.groundstate(jops.ham_heis(n, sparse=True))) \
        >= 1 - 1e-10


def test_groundenergy_dense():
    H = ops.ham_heis(6, device=CPU)
    assert bl.choose_backend(H, 1) == "numpy"
    want = jbl.groundenergy(jops.ham_heis(6))
    # one dense eigh of a 64 x 64 complex128 matrix
    assert float(quimb_torch.groundenergy(H)) == pytest.approx(
        float(want), rel=1e-12)
    assert _fidelity(quimb_torch.groundstate(H),
                     jbl.groundstate(jops.ham_heis(6))) >= 1 - 1e-10


def test_eigensystem_partial_two_lowest():
    H = ops.ham_heis(8, b=0.05, sparse=True)
    exact = np.linalg.eigvalsh(H.toarray())[:2]
    want = np.asarray(jbl.eigensystem_partial(
        jops.ham_heis(8, b=0.05, sparse=True), k=2, return_vecs=False))
    for backend in ("lanczos", "lobpcg", "scipy"):
        got = quimb_torch.eigensystem_partial(H, k=2, return_vecs=False,
                                              backend=backend, device=CPU)
        assert got.shape == (2,)
        # deflated Lanczos converged to 1e-10; LOBPCG's 60 fixed steps and
        # ARPACK to their tolerances
        np.testing.assert_allclose(got.numpy(), exact, rtol=1e-9)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9)
    lams, vecs = quimb_torch.eigensystem_partial(H, k=2, device=CPU)
    assert vecs.shape == (256, 2)
    res = H.toarray() @ vecs.numpy() - vecs.numpy() * lams.numpy()
    assert np.abs(res).max() < 1e-6
    # the largest two, largest first as in quimb_tpu
    lams = quimb_torch.eigensystem_partial(H, k=2, which="LA",
                                           return_vecs=False, device=CPU)
    np.testing.assert_allclose(lams.numpy(),
                               np.linalg.eigvalsh(H.toarray())[:-3:-1],
                               rtol=1e-9)
    np.testing.assert_allclose(lams.numpy(), np.asarray(
        jbl.eigensystem_partial(jops.ham_heis(8, b=0.05, sparse=True), k=2,
                                which="LA", return_vecs=False)), rtol=1e-9)


def test_eigensystem_partial_sigma():
    H = ops.ham_heis(4, device=CPU)
    el = np.linalg.eigvalsh(H.numpy())
    lams = quimb_torch.eigensystem_partial(H, k=3, sigma=0.1,
                                           return_vecs=False)
    want = np.sort(el[np.argsort(np.abs(el - 0.1))[:3]])
    # one dense eigh in complex128
    np.testing.assert_allclose(lams.numpy(), want, atol=1e-12)


def test_eigh_lanczos_and_eigsh_match():
    rng = np.random.default_rng(15)
    A = _rand_herm(rng, 80, complex_=False)
    v0 = rng.standard_normal(80)
    jlam, jv = jl.eigh_lanczos(jnp.asarray(A), jnp.asarray(v0), ncv=12,
                               restarts=30, tol=1e-12)
    tlam, tv = tl.eigh_lanczos(torch.as_tensor(A), torch.as_tensor(v0),
                               ncv=12, restarts=30, tol=1e-12)
    # float64 restarted Lanczos, stopped at 1e-12 on both
    assert float(tlam) == pytest.approx(float(jlam), rel=1e-11)
    assert _fidelity(tv, jv) >= 1 - 1e-10
    jl2, _ = jl.eigsh(jnp.asarray(A), k=2, v0=jnp.asarray(v0), ncv=16)
    tl2, tv2 = tl.eigsh(torch.as_tensor(A), k=2, v0=torch.as_tensor(v0),
                        ncv=16)
    # the Ritz values of one 16-vector basis: round-off of two builds
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=1e-10)
    assert tv2.shape == (2, 80)


def test_lobpcg_block_matches():
    rng = np.random.default_rng(16)
    A = _rand_herm(rng, 60)
    X0 = rng.standard_normal((60, 3)) + 0j
    jmu, _ = jl.lobpcg_block(jnp.asarray(A), jnp.asarray(X0), maxiter=80)
    tmu, X = tl.lobpcg_block(torch.as_tensor(A), torch.as_tensor(X0),
                             maxiter=80)
    exact = np.linalg.eigvalsh(A)[:3]
    # 80 blocked steps converge the three lowest to round-off
    np.testing.assert_allclose(tmu.numpy(), exact, atol=1e-9)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), atol=1e-9)
    assert X.shape == (60, 3)


# -- Krylov exp(tA) v and Evolution -------------------------------------------


@pytest.mark.parametrize("t", [0.3, -0.4j, 0.2 - 0.3j])
def test_expm_multiply_krylov_hermitian(t):
    rng = np.random.default_rng(17)
    A = _rand_herm(rng, 96) / 4
    v = rng.standard_normal(96) + 1j * rng.standard_normal(96)
    want = sla.expm(t * A) @ v
    jgot = np.asarray(jl.expm_multiply_krylov(
        jnp.asarray(A), jnp.asarray(v), t=t, ncv=30, hermitian=True))
    got = tl.expm_multiply_krylov(torch.as_tensor(A), torch.as_tensor(v),
                                  t=t, ncv=30, hermitian=True).numpy()
    # a 30-vector Krylov space of ||t A|| ~ 2: converged to round-off
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got, jgot, rtol=0, atol=1e-10)


def test_expm_multiply_krylov_arnoldi():
    rng = np.random.default_rng(18)
    A = _rand_herm(rng, 96) / 4
    B = rng.standard_normal((96, 96)) / 20
    v = rng.standard_normal(96) + 1j * rng.standard_normal(96)
    tA, tB = torch.as_tensor(A), torch.as_tensor(B + 0j)
    for M, t_mv, j_mv in (
            (-1j * A, lambda x: -1j * (tA @ x),
             lambda x: -1j * (jnp.asarray(A) @ x)),
            (B, lambda x: tB @ x, lambda x: jnp.asarray(B + 0j) @ x)):
        want = sla.expm(0.5 * M) @ v
        got = tl.expm_multiply_krylov(t_mv, torch.as_tensor(v), t=0.5,
                                      ncv=30, hermitian=False).numpy()
        jgot = np.asarray(jl.expm_multiply_krylov(
            j_mv, jnp.asarray(v), t=0.5, ncv=30, hermitian=False))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
        np.testing.assert_allclose(got, jgot, rtol=0, atol=1e-10)


def test_expm_multiply():
    rng = np.random.default_rng(19)
    A = _rand_herm(rng, 64) / 4
    v = rng.standard_normal(64)
    for mat, vec in ((-1j * A, v), (A.real, v), (A, v + 1j * v[::-1]),
                     (A.real, v + 1j * v[::-1])):
        want = sla.expm(mat) @ vec
        got = quimb_torch.expm_multiply(torch.as_tensor(mat), vec,
                                        device=CPU)
        jgot = np.asarray(jbl.expm_multiply(jnp.asarray(mat),
                                            jnp.asarray(vec)))
        assert got.shape == vec.shape
        # 40-vector Krylov spaces (Arnoldi for complex inputs)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
        np.testing.assert_allclose(got.numpy(), jgot, rtol=0, atol=1e-10)


class _Wrapped:
    """An operator known only by ``@``: Evolution takes the Arnoldi
    route."""

    def __init__(self, A):
        self.A, self.shape, self.dtype = A, A.shape, A.dtype

    def __matmul__(self, x):
        return self.A @ x


def _z0(psi, n):
    p = np.abs(_np(psi).ravel()) ** 2
    return float(np.sum(p * (1 - 2 * ((np.arange(2**n) >> (n - 1)) & 1))))


def test_evolution_expm_matches():
    n = 10
    Hj, Ht = jops.ham_heis(n, sparse=True), ops.ham_heis(n, sparse=True)
    p0 = states.computational_state("01" * (n // 2), device=CPU)
    j = jevo.Evolution(jstates.computational_state("01" * (n // 2)), Hj,
                       method="expm")
    t = quimb_torch.Evolution(p0, Ht, method="expm",
                              compute={"z0": lambda t, p: _z0(p, n)})
    Hd = Ht.toarray()
    for k in range(1, 5):
        j.update_to(k / 4)
        t.update_to(k / 4)
        assert t.t == k / 4 and t.pt.dtype == torch.complex128
        exact = sla.expm(-1j * k / 4 * Hd) @ p0.numpy()
        # one 32-vector Lanczos projection per update, complex128
        np.testing.assert_allclose(t.pt.numpy(), np.asarray(j.pt), rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(t.pt.numpy(), exact, rtol=0, atol=1e-10)
        assert t.results["z0"][-1] == pytest.approx(_z0(j.pt, n), abs=1e-10)
    assert abs(np.linalg.norm(t.pt.numpy()) - 1) < 1e-12


def test_evolution_routes_and_at_times():
    n = 8
    H = ops.ham_heis(n, sparse=True)
    Hd = torch.as_tensor(H.toarray().real)
    p0 = states.neel_state(n, dtype=torch.float64, device=CPU)
    ts = [0.2, 0.45]
    want = [sla.expm(-1j * t * Hd.numpy()) @ p0.numpy() for t in ts]
    for ham in (H, Hd, Hd.numpy(), quimb_torch.device_operator(H, device=CPU),
                _Wrapped(Hd.to(torch.complex128))):
        evo_ = quimb_torch.Evolution(p0, ham, method="expm", compute=lambda
                                     t, p: t)
        assert evo_._hermitian == (not isinstance(ham, _Wrapped))
        got = [p.numpy() for p in evo_.at_times(ts)]
        # Lanczos or Arnoldi on 32 vectors, complex128
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
        assert evo_.results == ts
    c64 = quimb_torch.Evolution(p0.to(torch.float32), H, method="expm")
    c64.update_to(0.2)
    assert c64.pt.dtype == torch.complex64
    # float32 Lanczos on 32 vectors
    np.testing.assert_allclose(c64.pt.numpy(), want[0], rtol=0, atol=1e-5)
    # the integrate and solve methods are ported: quimb_tpu's values
    for method in ("integrate", "solve"):
        jm = jevo.Evolution(jstates.computational_state("01" * (n // 2)),
                            jops.ham_heis(n, sparse=True), method=method)
        tm = quimb_torch.Evolution(p0, H, method=method)
        for got, want_ in zip(tm.at_times(ts), jm.at_times(ts)):
            # RK45 at quimb_tpu's rtol 1e-8 and atol 1e-10, the same steps
            np.testing.assert_allclose(got.numpy(), np.asarray(want_),
                                       rtol=0, atol=1e-10)


def test_evolution_of_quimb_tpu_operator():
    """quimb_tpu's own operator, carried across, evolves as the port's."""
    n = 8
    H = jops.ham_heis(n, sparse=True)
    op = from_tpu_operator(H, device=CPU)
    assert isinstance(op, core.LocalTermsHam)
    p0 = states.neel_state(n, device=CPU)
    a = quimb_torch.Evolution(p0, op, method="expm")
    b = quimb_torch.Evolution(p0, ops.ham_heis(n, sparse=True),
                              method="expm")
    a.update_to(0.3)
    b.update_to(0.3)
    np.testing.assert_array_equal(a.pt.numpy(), b.pt.numpy())


# -- entry points without a device --------------------------------------------


@pytest.mark.parametrize("build", [
    lambda: [quimb_torch.ham_heis(4)],
    lambda: [quimb_torch.computational_state("0101")],
    lambda: [quimb_torch.neel_state(4)],
    lambda: [ops.pauli("X")],
    lambda: [core.quimbify(np.ones(4))],
    lambda: quimb_torch.device_operator(
        ops.ham_heis(4, sparse=True)).mats,
    lambda: [from_tpu_operator(jops.ham_heis(4, sparse=True)).mats[0]],
    lambda: [quimb_torch.groundenergy(ops.ham_heis(6, sparse=True))],
    lambda: [quimb_torch.Evolution(np.eye(16)[3], ops.ham_heis(
        4, sparse=True), method="expm").pt],
])
def test_entry_points_default_to_the_gpu(build):
    """With no ``device``, the tensors go to the GPU; with no GPU the call
    raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in build())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()

