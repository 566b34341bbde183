"""The names and keywords that ``test_torch_api_parity.py`` found missing
from quimb_torch, against quimb_tpu on the same numpy inputs, in float64 /
complex128 on the CPU: the circuits' ``simulate_counts`` and ``xeb``,
``SpinHam1D.build_sparse`` / ``build_dense``, ``isometrize(method="mgs")``,
``tensor.array_ops.to_host``, the generators' ``sparse=`` /
``ownership=``, ``kron`` /
``ikron`` / ``quimbify``'s sparse-format keywords, the linear-algebra
keywords and the ``ops`` index. TEBD's and DMRG's keywords are in
``test_torch_api_gaps_1d.py``; the mesh's ``devices=`` and
``DMRGX.shard_onto`` run in the gloo worlds of ``test_torch_parallel.py``
and ``test_torch_mesh_dmrg.py``."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import quimb_tpu.core as jcore
import quimb_tpu.gen.states as jstates
import quimb_tpu.linalg.approx_spectral as jas
import quimb_tpu.linalg.base_linalg as jbl
import quimb_tpu.linalg.lanczos as jl
import quimb_tpu.ops as jops
import quimb_tpu.ops.decomp as jdecomp
import quimb_tpu.tensor as jtn
import quimb_torch
import quimb_torch.core as tcore
import quimb_torch.gen.states as tstates
import quimb_torch.linalg.approx_spectral as tas
import quimb_torch.linalg.base_linalg as tbl
import quimb_torch.linalg.lanczos as tl
import quimb_torch.ops as tops
import quimb_torch.ops.decomp as tdecomp
import quimb_torch.tensor as ttn
from quimb_torch.config import get_default_dtype
from quimb_tpu.ops.contraction import contract_backend as jbackend

CPU = "cpu"


def _np(x):
    if sp.issparse(x):
        return x.toarray()
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().numpy()
    return np.asarray(x)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the circuits' simulate_counts and xeb ------------------------------------


def _gates(Lx, Ly, depth, seed):
    """``depth`` layers of U3 on every qubit and CZ on every lattice bond
    (qubit q at (q // Ly, q % Ly)), from a seeded numpy stream."""
    rng = np.random.default_rng(seed)
    bonds = [(i * Ly + j, i * Ly + j + 1) for i in range(Lx)
             for j in range(Ly - 1)]
    bonds += [(i * Ly + j, (i + 1) * Ly + j) for i in range(Lx - 1)
              for j in range(Ly)]
    gates = []
    for _ in range(depth):
        gates += [("U3", *rng.uniform(0, 2 * np.pi, 3), q)
                  for q in range(Lx * Ly)]
        gates += [("CZ", a, b) for a, b in bonds]
    return gates


def _circuit_pair(cls, Lx, Ly):
    if cls == "CircuitPEPS":
        kw = dict(max_bond=32, cutoff=0.0)
        args = (Lx, Ly)
    else:
        kw, args = {}, (Lx * Ly,)
    j = getattr(jtn, cls)(*args, **kw)
    t = getattr(ttn, cls)(*args, device=CPU, **kw)
    gates = _gates(Lx, Ly, 2, seed=Lx + 7 * Ly)
    j.apply_gates(gates)
    t.apply_gates(gates)
    return j, t


@pytest.mark.parametrize("cls,Lx,Ly", [("CircuitMPS", 2, 4),
                                       ("CircuitPEPS", 2, 4),
                                       ("CircuitDense", 2, 5)])
def test_simulate_counts_and_xeb(cls, Lx, Ly):
    """``CircuitBase``'s two methods on three circuit classes at 8-10
    qubits: the counts of ``default_rng(seed).choice`` over the same
    |psi|^2 are equal, the XEB of 30 strings agrees to 1e-10 (sums of
    float64 probabilities of a state exact in both packages)."""
    j, t = _circuit_pair(cls, Lx, Ly)
    with jbackend("numpy"):
        want = j.simulate_counts(200, seed=5)
        strings = [np.binary_repr(s, Lx * Ly) for s in
                   np.random.default_rng(6).integers(0, 2**(Lx * Ly), 30)]
        jx = j.xeb(strings)
    assert t.simulate_counts(200, seed=5) == want
    assert sum(want.values()) == 200
    assert t.xeb(strings) == pytest.approx(jx, abs=1e-10)
    ints = [int(s, 2) for s in strings]
    assert t.xeb(ints) == pytest.approx(jx, abs=1e-10)


def test_circuit_keeps_its_own_overrides():
    """``Circuit`` samples through its own marginals, as quimb_tpu's."""
    assert ttn.Circuit.xeb is not ttn.CircuitBase.xeb
    assert ttn.Circuit.simulate_counts is not ttn.CircuitBase.simulate_counts
    assert ttn.CircuitDense.xeb is ttn.CircuitBase.xeb


# -- SpinHam1D.build_sparse / build_dense -------------------------------------


def _spin_hams(S, cyclic):
    hams = []
    for mod in (jtn, ttn):
        H = mod.SpinHam1D(S=S, cyclic=cyclic)
        H += 1.0, "X", "X"
        H += 0.6, "Z", "Z"
        H += 0.3, "Z"
        H[2] += 0.25, "X"
        H[3, 4] += -0.4, "Y", "Y"
        hams.append(H)
    return hams


@pytest.mark.parametrize("S", [1 / 2, 1])
@pytest.mark.parametrize("cyclic", [False, True])
def test_spin_ham_1d_build_sparse_and_dense(S, cyclic):
    """The host CSR matrix at L=8 equals quimb_tpu's at 1e-12 (sums of a
    few products of spin matrices); the dense tensor equals it in the
    default dtype, at L=8 for S=1/2 and L=5 for S=1 (a dense 3^8 matrix is
    0.7 GB)."""
    jh, th = _spin_hams(S, cyclic)
    A, B = th.build_sparse(8), jh.build_sparse(8)
    assert sp.issparse(A) and A.dtype == B.dtype == np.complex128
    assert A.shape == B.shape
    assert abs(A - B).max() < 1e-12
    L = 8 if S == 1 / 2 else 5
    D = th.build_dense(L, device=CPU)
    assert D.dtype == get_default_dtype() and D.device.type == CPU
    np.testing.assert_allclose(_np(D), _np(jh.build_dense(L)), rtol=0,
                               atol=1e-12)


# -- isometrize(method="mgs") and the ops index -------------------------------


def test_isometrize_mgs():
    """quimb_tpu's "mgs" is its stabilised QR: the same projector Q Q^H at
    1e-12 (a QR of a well-conditioned 7 x 4 matrix)."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((7, 4)) + 1j * rng.standard_normal((7, 4))
    Q = _np(tdecomp.isometrize(torch.as_tensor(X), method="mgs"))
    jQ = _np(jdecomp.isometrize(X, method="mgs"))
    np.testing.assert_allclose(Q @ Q.conj().T, jQ @ jQ.conj().T, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(Q.conj().T @ Q, np.eye(4), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(
        Q, _np(tdecomp.isometrize_mgs(torch.as_tensor(X))))


def test_ops_index_names():
    for name in ("array_split", "compute_oblique_projectors", "isometrize",
                 "lq_stabilized", "qr_stabilized",
                 "squared_op_to_reduced_factor", "svd_truncated",
                 "svd_truncated_masked"):
        assert getattr(tops, name) is getattr(tdecomp, name)
    assert set(tops.__all__) == set(jops.__all__)


def test_to_host_in_tensor_array_ops():
    from quimb_torch.ops.backend import to_host
    from quimb_torch.tensor import array_ops

    x = torch.arange(6.0).reshape(2, 3)
    assert array_ops.to_host is to_host
    np.testing.assert_array_equal(array_ops.to_host(x), x.numpy())


# -- the generators' sparse= / ownership=, and kron / ikron / quimbify --------


@pytest.mark.parametrize("make", [
    lambda m, **kw: m.basis_vec(5, 16, ownership=(0, 8), sparse=True, **kw),
    lambda m, **kw: m.bloch_state(0.3, -0.2, 0.5, purified=True, sparse=True,
                                  **kw),
    lambda m, **kw: m.computational_state("0110", sparse=True, **kw),
    lambda m, **kw: m.graph_state_1d(5, sparse=True, **kw),
    lambda m, **kw: m.graph_state_1d(4, True, False, **kw),
])
def test_generators_sparse_keywords(make):
    """quimb_tpu ignores ``sparse`` and ``ownership`` and returns a dense
    array; so does the port (1e-14: at most a few products of 1/sqrt(2))."""
    got = make(tstates, device=CPU)
    want = make(jstates)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-14)


def test_kron_ikron_quimbify_keywords():
    """``stype``, ``coo_build``, ``parallel`` and ``ownership`` are
    ignored by both packages: the products equal quimb_tpu's (1e-14), a
    sparse factor still gives a host CSR matrix."""
    rng = np.random.default_rng(8)
    a, b = rng.standard_normal((2, 2)), rng.standard_normal((3, 3))
    kw = dict(stype="coo", coo_build=True, parallel=True, ownership=(0, 3))
    np.testing.assert_allclose(
        _np(tcore.kron(torch.as_tensor(a), torch.as_tensor(b), **kw)),
        _np(jcore.kron(a, b, **kw)), rtol=0, atol=1e-14)
    s = tcore.kron(sp.csr_matrix(a), b, **kw)
    assert sp.issparse(s)
    np.testing.assert_allclose(s.toarray(), _np(jcore.kron(a, b)), rtol=0,
                               atol=1e-14)
    dims = (2, 3, 2)
    np.testing.assert_allclose(
        _np(tcore.ikron(torch.as_tensor(b), dims, 1, **kw)),
        _np(jcore.ikron(b, dims, 1, **kw)), rtol=0, atol=1e-14)
    np.testing.assert_allclose(
        _np(tcore.ikron(b, dims, 1, sparse=True, **kw)),
        _np(jcore.ikron(b, dims, 1, sparse=True, **kw)), rtol=0, atol=1e-14)
    v = rng.standard_normal(4)
    np.testing.assert_allclose(
        _np(tcore.quimbify(v, qtype="dop", stype="csr", device=CPU)),
        _np(jcore.quimbify(v, qtype="dop", stype="csr")), rtol=0,
        atol=1e-14)


# -- the linear-algebra keywords ----------------------------------------------


def _herm(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    return A + A.T


def test_lobpcg_tol_and_choose_backend_b():
    """``lobpcg_block(tol=)`` runs quimb_tpu's fixed count of iterations
    (eigenvalues at 1e-10 of quimb_tpu's on a 40 x 40 matrix);
    ``choose_backend(B=)`` picks quimb_tpu's backend."""
    import jax.numpy as jnp

    A = _herm(40, 4)
    X0 = np.random.default_rng(5).standard_normal((40, 3))
    jmu, _ = jl.lobpcg_block(jnp.asarray(A), jnp.asarray(X0), maxiter=80,
                             tol=1e-3)
    tmu, _ = tl.lobpcg_block(torch.as_tensor(A), torch.as_tensor(X0),
                             maxiter=80, tol=1e-3)
    np.testing.assert_allclose(_np(tmu), _np(jmu), rtol=0, atol=1e-10)
    H = quimb_torch.ham_heis(8, sparse=True)
    for op in (H, A):
        assert tbl.choose_backend(op, 1, B=None) == jbl.choose_backend(
            op, 1, B=None)


def test_eigensystem_partial_and_eigsh_device_keywords():
    """``eigensystem_partial(B=, sort=, fallback_to_scipy=)`` and
    ``eigsh_device(A=)``: quimb_tpu's two lowest energies of the 8-site
    Heisenberg chain (float64 Lanczos, 1e-10)."""
    Hs = quimb_torch.ham_heis(8, sparse=True)
    kw = dict(B=None, sort=True, fallback_to_scipy=False,
              return_vecs=False)
    got = tbl.eigensystem_partial(Hs, 2, device=CPU, **kw)
    want = jbl.eigensystem_partial(Hs, 2, **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-10)
    A = _herm(30, 6)
    v0 = np.random.default_rng(7).standard_normal(30)
    At = torch.as_tensor(A)
    lam, _ = tbl.eigsh_device(lambda x: At @ x, torch.as_tensor(v0), k=1,
                              A=At)
    np.testing.assert_allclose(_np(lam), np.linalg.eigvalsh(A)[:1], rtol=0,
                               atol=1e-10)


def test_expm_multiply_backend_and_lanczos_matvec():
    """``expm_multiply(backend=)`` is ignored in both (Krylov, 1e-12 of
    quimb_tpu's on a 30 x 30 hermitian matrix); ``construct_lanczos_tridiag
    (matvec=)`` takes quimb_tpu's one-vector function, batched over the
    probes (1e-12 of quimb_tpu's tridiagonals)."""
    import jax.numpy as jnp

    A = _herm(30, 9) / 10
    v = np.random.default_rng(10).standard_normal(30)
    for backend in ("AUTO", "scipy"):
        np.testing.assert_allclose(
            _np(tbl.expm_multiply(torch.as_tensor(A), torch.as_tensor(v),
                                  backend=backend)),
            _np(jbl.expm_multiply(jnp.asarray(A), jnp.asarray(v),
                                  backend=backend)), rtol=0, atol=1e-12)
    V0 = np.random.default_rng(11).choice([-1.0, 1.0], size=(4, 30))
    At, Aj = torch.as_tensor(A), jnp.asarray(A)
    at, bt = tas.construct_lanczos_tridiag(
        matvec=lambda x: At @ x, n=30, K=8, V0=torch.as_tensor(V0),
        dtype=torch.float64)
    aj, bj = jas.construct_lanczos_tridiag(
        matvec=lambda x: Aj @ x, n=30, K=8, V0=jnp.asarray(V0),
        dtype="float64")
    np.testing.assert_allclose(_np(at), _np(aj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_np(bt), _np(bj), rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        tas.construct_lanczos_tridiag(n=30, K=8, V0=torch.as_tensor(V0))
