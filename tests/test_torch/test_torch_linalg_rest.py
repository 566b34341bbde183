"""The rest of quimb_torch's ``linalg/base_linalg.py`` and
``linalg/autoblock.py`` against quimb_tpu's, on the CPU: the full
eigensystems (hermitian and not), their forms, the spectral windows, SVDs,
norms, ``expm``, ``sqrtm``, ``Lazy``, ``IdentityLinearOperator`` and the
block-detected eigensystem. Inputs from ``np.random.default_rng`` in
complex128; eigenvalues agree to 1e-11 absolute (O(1) spectra, LAPACK on
both sides), eigenvectors are compared as projectors or by ``A v = l v``."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import quimb_tpu.linalg.autoblock as jab
import quimb_tpu.linalg.base_linalg as jbl
from quimb_torch import core
from quimb_torch.linalg import autoblock as tab
from quimb_torch.linalg import base_linalg as tbl

CPU = "cpu"


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _herm(rng, d):
    X = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
    return (X + X.conj().T) / 2


def _proj(v):
    v = np.asarray(v)
    return v @ v.conj().T


def test_full_eigensystems():
    rng = np.random.default_rng(0)
    A = _herm(rng, 12)
    G = rng.standard_normal((7, 7))
    el, ev = tbl.eigh(_t(A))
    jl, jv = jbl.eigh(A)
    np.testing.assert_allclose(_np(el), np.asarray(jl), atol=1e-11)
    np.testing.assert_allclose(_proj(_np(ev)[:, :3]),
                               _proj(np.asarray(jv)[:, :3]), atol=1e-10)
    np.testing.assert_allclose(_np(tbl.eigvalsh(_t(A))), np.asarray(jl),
                               atol=1e-11)
    np.testing.assert_allclose(_np(tbl.eigvalsh(sp.csr_matrix(A),
                                                device=CPU)),
                               np.asarray(jl), atol=1e-11)
    wl, wv = tbl.eig(_t(G))
    np.testing.assert_allclose(_np(wl), np.asarray(jbl.eigvals(G)),
                               atol=1e-11)
    np.testing.assert_allclose(_np(_t(G).to(wv.dtype) @ wv),
                               _np(wv * wl), atol=1e-11)
    np.testing.assert_allclose(_np(tbl.eigvals(_t(G))), _np(wl), atol=0)
    v = tbl.eigvecsh(_t(A))
    np.testing.assert_allclose(_proj(_np(v)[:, :1]),
                               _proj(np.asarray(jbl.eigvecsh(A))[:, :1]),
                               atol=1e-10)
    assert tbl.eigenvectors(_t(A)).shape == (12, 12)
    lk, vk = tbl.eigh(_t(A), k=3, backend="numpy")
    np.testing.assert_allclose(_np(lk), np.asarray(jl)[:3], atol=1e-11)


def test_windows_and_bounds():
    rng = np.random.default_rng(1)
    A = _herm(rng, 40)
    w = np.linalg.eigvalsh(A)
    lo, hi = tbl.bound_spectrum(_t(A), backend="numpy")
    assert (float(lo), float(hi)) == pytest.approx((w[0], w[-1]), abs=1e-11)
    for w0, k in ((0.5, 4), (0.1, 1), (0.9, 3)):
        got = tbl.eigvalsh_window(_t(A), w0, k)
        want = jbl.eigvalsh_window(A, w0, k)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-11)
        v = tbl.eigvecsh_window(_t(A), w0, k)
        np.testing.assert_allclose(_proj(_np(v)),
                                   _proj(jbl.eigvecsh_window(A, w0, k)),
                                   atol=1e-10)
    # the iterative route: bounds by Lanczos, then the folded spectrum
    H = sp.random(120, 120, density=0.05, random_state=3)
    H = (H + H.T) / 2
    dev_op = core.SparseHam(H, dtype=torch.float64, device=CPU)
    wh = np.linalg.eigvalsh(H.toarray())
    got = tbl.eigvalsh_window(dev_op, 0.5, 1, tol=1e-12, ncv=40,
                              restarts=40)
    target = wh[0] + 0.5 * (wh[-1] - wh[0])
    want = wh[np.argmin(np.abs(wh - target))]
    assert float(got[0]) == pytest.approx(want, abs=1e-6)


def test_svd_norms_and_matrix_functions():
    rng = np.random.default_rng(2)
    M = rng.standard_normal((9, 6)) + 1j * rng.standard_normal((9, 6))
    A = _herm(rng, 8)
    U, s, VH = tbl.svd(_t(M))
    np.testing.assert_allclose(_np(s), np.asarray(jbl.svd(
        M, return_vecs=False)), atol=1e-12)
    np.testing.assert_allclose(_np((U * s.to(U.dtype)) @ VH), M, atol=1e-12)
    Uk, sk, VHk = tbl.svds(_t(M), 3)
    jU, js, jVH = jbl.svds(M, 3)
    np.testing.assert_allclose(_np(sk), np.asarray(js), atol=1e-12)
    np.testing.assert_allclose(_np((Uk * sk.to(Uk.dtype)) @ VHk),
                               np.asarray((jU * js) @ jVH), atol=1e-11)
    np.testing.assert_allclose(_np(tbl.svds(_t(M), 2, return_vecs=False)),
                               np.asarray(js)[:2], atol=1e-12)
    for ntype in (2, "fro", "tr", "nuc", "spectral"):
        assert float(tbl.norm(_t(A), ntype)) == pytest.approx(
            float(jbl.norm(A, ntype)), abs=1e-11)
    assert float(tbl.norm_trace(_t(M[:6]), isherm=False)) == pytest.approx(
        float(jbl.norm_trace(M[:6], isherm=False)), abs=1e-11)
    for herm in (True, False):
        np.testing.assert_allclose(
            _np(tbl.expm(_t(0.3j * A), herm=False)),
            np.asarray(jbl.expm(0.3j * A)), atol=1e-12)
        np.testing.assert_allclose(
            _np(tbl.expm(_t(0.3 * A), herm=herm)),
            np.asarray(jbl.expm(0.3 * A, herm=herm)), atol=1e-12)
    P = A @ A
    np.testing.assert_allclose(_np(tbl.sqrtm(_t(P))),
                               np.asarray(jbl.sqrtm(P)), atol=1e-11)
    np.testing.assert_allclose(_np(tbl.sqrtm(_t(P), herm=False)),
                               np.asarray(jbl.sqrtm(P, herm=False)),
                               atol=1e-10)
    np.testing.assert_allclose(_np(tbl.sqrtm(sp.csr_matrix(P),
                                             device=CPU)),
                               np.asarray(jbl.sqrtm(P)), atol=1e-11)


def test_lazy_and_identity_operators():
    rng = np.random.default_rng(3)
    A = _herm(rng, 10)
    lz = tbl.Lazy(lambda a, scale=1.0: _t(a) * scale, A, scale=2.0,
                  shape=(10, 10), factor=0.5)
    assert "Lazy" in repr(lz)
    e = tbl.groundenergy(lz, backend="lanczos", tol=1e-13, restarts=80)
    assert float(e) == pytest.approx(np.linalg.eigvalsh(A)[0], abs=1e-9)
    with pytest.raises(TypeError):
        tbl.Lazy(lambda: 0)
    ident = tbl.IdentityLinearOperator(5, factor=3)
    x = torch.arange(5.0)
    assert torch.equal(ident @ x, 3 * x) and ident.shape == (5, 5)
    assert torch.equal(ident.matvec(x), 3 * x)
    assert tbl.choose_backend(_t(A), 1) == jbl.choose_backend(A, 1)


def test_autoblocked_eigensystem():
    """A block-diagonal operator hidden by a permutation: blocks of sizes
    1, 3, 3 and 5, two of them solved in one batched eigh."""
    rng = np.random.default_rng(4)
    sizes = (1, 3, 3, 5)
    A = np.zeros((12, 12), complex)
    i = 0
    for s in sizes:
        A[i:i + s, i:i + s] = _herm(rng, s)
        i += s
    perm = rng.permutation(12)
    A = A[np.ix_(perm, perm)]
    blocks_t = tab.compute_blocks(*np.nonzero(A), 12)
    assert blocks_t == jab.compute_blocks(*np.nonzero(A), 12)
    assert sorted(map(len, blocks_t)) == sorted(sizes)
    el, ev = tab.eigensystem_autoblocked(_t(A))
    jl, jv = jab.eigensystem_autoblocked(A)
    np.testing.assert_allclose(_np(el), np.asarray(jl), atol=1e-11)
    np.testing.assert_allclose(_np(_t(A) @ ev), _np(ev * el.to(ev.dtype)),
                               atol=1e-11)
    np.testing.assert_allclose(
        _np(tbl.eigensystem(sp.csr_matrix(A), autoblock=True,
                            return_vecs=False, device=CPU)),
        np.asarray(jl), atol=1e-11)
    with pytest.raises(ValueError):
        tab.eigensystem_autoblocked(_t(A), isherm=False)
