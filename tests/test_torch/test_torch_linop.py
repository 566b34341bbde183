"""quimb_torch's tensor linear operators and spectral estimates
(``tensor/linop.py``, ``linalg/approx_spectral.py``,
``tensor/tensor_approx_spectral.py``, ``linalg/rand_linalg.py``) against
quimb_tpu's, on the CPU in float64 and complex128, from the same arrays.

Tolerances: 1e-12 relative on every product and dense form (one exact
contraction). SLQ with the same Rademacher probes (numpy draws of one
seed in both packages): the Lanczos coefficients to 1e-10 and the
estimates to 1e-10 relative (the same recurrence; the port batches the
probes, quimb_tpu maps over them, measured 1e-15 apart), except on the
8 x 8 reduced density matrix, whose Krylov space fills at K = n = 8: the
recurrence, without reorthogonalization, amplifies round-off there
(complex128 measured 1.5e-8 apart; bound 1e-7); against the
exact trace, within the estimator's own stopping rule. Randomized SVDs
draw their sketches from other generators (torch's, JAX's): the leading
singular values of a matrix with a decaying spectrum are compared, at
1e-10 relative to the largest, with numpy's exact ones."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quimb_torch.tensor as ttn
import quimb_tpu.tensor as jtn
from quimb_torch import convert
from quimb_torch.linalg import approx_spectral as tas
from quimb_torch.linalg import rand_linalg as trl
from quimb_torch.ops import decomp as tdecomp
from quimb_tpu.linalg import approx_spectral as jas
from quimb_tpu.linalg import rand_linalg as jrl
from quimb_tpu.tensor.tensor_approx_spectral import (
    tensor_network_approx_spectral_function as jtasf,
)

RTOL = 1e-12


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b):
    return np.linalg.norm(_n(a) - _n(b)) / np.linalg.norm(_n(b))


@pytest.fixture(scope="module", params=["float64", "complex128"])
def ops(request):
    j = jtn.MPS_rand_state(6, 4, seed=7, dtype=request.param)
    t = convert.from_tpu_mps(j, device="cpu")
    return j.partial_trace_linop((1, 2, 3)), t.partial_trace_linop((1, 2, 3))


def test_products_match(ops):
    jA, tA = ops
    assert tA.shape == jA.shape == (8, 8)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(8) + 1j * rng.standard_normal(8)
    v = v if tA.dtype.is_complex else v.real
    X = rng.standard_normal((8, 3))
    assert _rel(tA.matvec(v), jA.matvec(v)) <= RTOL
    assert _rel(tA.rmatvec(v), jA.rmatvec(v)) <= RTOL
    assert _rel(tA.matmat(X), jA.matmat(X)) <= RTOL
    assert isinstance(tA.matvec(torch.as_tensor(v)), torch.Tensor)
    assert _rel(tA.to_dense(), jA.to_dense()) <= RTOL
    assert _rel(tA.H.to_dense(), jA.H.to_dense()) <= RTOL
    assert _rel(tA.conj().to_dense(), jA.conj().to_dense()) <= RTOL
    assert _rel(tA.copy(transpose=True).to_dense(),
                jA.copy(transpose=True).to_dense()) <= RTOL
    sp = tA.aslinearoperator()
    assert _rel(sp @ v, jA.matvec(v)) <= RTOL
    assert _rel(sp.matmat(X), jA.matmat(X)) <= RTOL
    # one cached expression per key
    assert set(tA._exprs) >= {"mv", "rmv", ("mm", 3)}


def test_aslinearoperator_and_1d_section():
    j = jtn.MPS_rand_state(5, 3, seed=2)
    t = convert.from_tpu_mps(j, device="cpu")
    jop = j.aslinearoperator(["k0", "k1"], ["k2", "k3", "k4"])
    top = t.aslinearoperator(["k0", "k1"], ["k2", "k3", "k4"])
    assert top.shape == (4, 8)
    assert _rel(top.to_dense(), jop.to_dense()) <= RTOL
    lop = ttn.TNLinearOperator(t.tensors, ["k0", "k1"], ["k2", "k3", "k4"])
    assert _rel(lop.to_dense(), jop.to_dense()) <= RTOL


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_lanczos_tridiag_matches(dtype):
    rng = np.random.default_rng(3)
    n, K, R = 20, 8, 5
    M = rng.standard_normal((n, n))
    if dtype == "complex128":
        M = M + 1j * rng.standard_normal((n, n))
    A = M @ M.conj().T
    V0 = rng.choice([-1.0, 1.0], size=(R, n)).astype(dtype)
    Aj = jnp.asarray(A)
    aj, bj = jas.construct_lanczos_tridiag(lambda x: Aj @ x, n, K,
                                           jnp.asarray(V0), dtype)
    At = torch.as_tensor(A)
    at, bt = tas.construct_lanczos_tridiag(lambda X: At @ X, n, K,
                                           torch.as_tensor(V0))
    assert _rel(at, aj) <= 1e-10 and _rel(bt, bj) <= 1e-10
    wj, tj = jas._quadrature_weights(aj, bj)
    wt, tt = tas._quadrature_weights(at, bt)
    assert _rel(wt, wj) <= 1e-10 and _rel(tt, tj) <= 1e-10


def test_tn_spectral_function_matches(ops):
    """Tr rho log2 rho of the block's reduced density matrix, by SLQ on
    the lazy network with the same probes, against quimb_tpu's and against
    the exact value within the stopping rule (tol x scale)."""
    jA, tA = ops
    f = tas._np_xlogx
    want = jtasf(jA.tn, f, jA.left_inds, jA.right_inds, pos=True, seed=3,
                 tol=1e-2, R=48)
    info = {}
    got = ttn.tensor_network_approx_spectral_function(
        tA.tn, f, tA.left_inds, tA.right_inds, pos=True, seed=3, tol=1e-2,
        R=48, info=info)
    assert abs(got - want) <= 1e-7 * abs(want)
    w = np.linalg.eigvalsh(_n(tA.to_dense()))
    exact = float(np.sum(f(np.clip(w, 0, None))))
    assert info["R"] <= 48
    # the estimator's standard error, five times over: a Gaussian tail of
    # 6e-7
    assert abs(got - exact) <= 5 * info["error"] + 1e-12
    # quimb_tpu's tr_xlogx_approx cannot take a TNLinearOperator (its
    # host matvec meets a JAX tracer); the port's can
    assert abs(tas.tr_xlogx_approx(tA, seed=3, tol=1e-2, R=48) - want) <= \
        1e-7 * abs(want)


@pytest.mark.parametrize("name", ["entropy_subsys_approx",
                                  "tr_sqrt_subsys_approx"])
def test_lazy_ptr_estimates_match(name):
    rng = np.random.default_rng(5)
    psi = rng.standard_normal(2**8)
    psi /= np.linalg.norm(psi)
    kw = dict(seed=2, tol=1e-2, R=24)
    want = getattr(jas, name)(psi, [2] * 8, [0, 1, 2], **kw)
    got = getattr(tas, name)(psi, [2] * 8, [0, 1, 2], device="cpu", **kw)
    assert abs(got - want) <= 1e-10 * abs(want)


@pytest.mark.parametrize("name", ["logneg_subsys_approx",
                                  "negativity_subsys_approx"])
def test_ppt_estimates_match(name):
    rng = np.random.default_rng(6)
    psi = rng.standard_normal(2**6) + 1j * rng.standard_normal(2**6)
    psi /= np.linalg.norm(psi)
    kw = dict(seed=4, tol=1e-2, R=24)
    want = getattr(jas, name)(psi, [2] * 6, [0, 1], [2, 3], **kw)
    got = getattr(tas, name)(psi, [2] * 6, [0, 1], [2, 3], device="cpu",
                             **kw)
    assert abs(got - want) <= 1e-10 * max(abs(want), 1e-12)
    op = tas.LazyPtrPptOperator(torch.as_tensor(psi), [2] * 6, [0, 1],
                                [2, 3])
    X = torch.as_tensor(rng.standard_normal((16, 3))).to(op.dtype)
    cols = torch.stack([op.matvec(X[:, k]) for k in range(3)], dim=1)
    assert _rel(op.matmat(X), cols) <= RTOL


@pytest.mark.parametrize("f", ["tr_abs_approx", "tr_exp_approx",
                               "tr_sqrt_approx"])
def test_dense_trace_estimates_match(f):
    rng = np.random.default_rng(8)
    M = rng.standard_normal((30, 30))
    A = M @ M.T / 30
    want = getattr(jas, f)(A, seed=1, tol=1e-2, R=24)
    got = getattr(tas, f)(torch.as_tensor(A), seed=1, tol=1e-2, R=24)
    assert abs(got - want) <= 1e-10 * abs(want)


def test_xlogx():
    x = np.array([0.0, 0.25, 0.5, 1.0, -1.0])
    np.testing.assert_allclose(tas.xlogx(torch.as_tensor(x)).numpy(),
                               np.asarray(jas.xlogx(x)), rtol=1e-15)


def _decaying(seed=1, m=60, n=50, r=40):
    a = np.random.default_rng(seed).standard_normal((m, r))
    b = np.random.default_rng(seed + 1).standard_normal((r, n))
    return a @ np.diag(0.3 ** np.arange(r)) @ b


def test_rsvd_fixed_rank_matches():
    M = _decaying()
    s = np.linalg.svd(M, compute_uv=False)
    sj = np.asarray(jrl.rsvd(M, 8, p=10, compute_uv=False))
    U, st, VH = trl.rsvd(M, 8, p=10, seed=1, device="cpu")
    assert st.shape == (8,) and U.shape == (60, 8) and VH.shape == (8, 50)
    assert np.max(np.abs(st.numpy() - s[:8])) <= 1e-10 * s[0]
    assert np.max(np.abs(sj - s[:8])) <= 1e-10 * s[0]
    # the factors are orthonormal and reproduce the rank-8 truncation
    trunc = (U * st) @ VH
    best = (np.linalg.svd(M)[0][:, :8] * s[:8]) @ np.linalg.svd(M)[2][:8]
    assert _rel(trunc, best) <= 1e-9


def test_rsvd_cutoff_and_helpers():
    M = _decaying(3)
    s = np.linalg.svd(M, compute_uv=False)
    eps = 1e-4
    k = int(np.sum(s >= eps * s[0]))
    sj = np.asarray(jrl.rsvd(M, eps, compute_uv=False))
    st = trl.rsvd(M, eps, compute_uv=False, seed=2, device="cpu")
    assert len(sj) == len(st) == k
    assert np.max(np.abs(st.numpy() - s[:k])) <= 1e-10 * s[0]
    assert trl.count_svdvals_needed(torch.as_tensor(s), eps) == k
    assert len(trl.isvd(M, eps, seed=2, device="cpu")[1]) == k
    Mt = torch.as_tensor(M)
    assert tdecomp.estimate_rank(Mt, eps=eps, k_start=4, seed=0) == \
        jrl.estimate_rank(jnp.asarray(M), eps=eps, k_start=4) == k
    U, st2, VH = trl.rsvd_iterate(Mt, eps, k_start=4, seed=0)
    assert len(st2) >= k and _rel(U.T @ U, np.eye(U.shape[1])) <= 1e-12
