"""quimb_torch's ``array_split`` and its drivers against quimb_tpu's, on the
CPU, in float64 and complex128.

The same numpy matrix, from ``np.random.default_rng(seed)``, goes to both
packages. Singular vectors carry a gauge (a sign or phase per column), so
the factors are compared through gauge-free products: ``left @ right`` for
the absorbing modes, the projectors ``U Uᴴ`` and ``VHᴴ VH`` for the
isometric ones. Tolerances, relative in the Frobenius norm: 1e-12 for
singular values; 1e-10 for products of split factors, which two LAPACK
calls on one float64 input reproduce to round-off times the inverse
spectral gap of a matrix whose values decay to 1e-3. Factors that are
unique (sign-fixed QR / LQ, Cholesky, polar, LU with pivoting) are
compared directly at 1e-10.
"""

import numpy as np
import pytest
import torch

from quimb_tpu.ops import decomp as jdecomp
from quimb_torch.ops import contraction as tctr
from quimb_torch.ops import decomp as tdecomp

TOL = 1e-10
TOL_S = 1e-12
DTYPES = ["float64", "complex128"]
ABSORBS = ["both", "left", "right", None, "lorthog", "rorthog", "lfactor",
           "rfactor", "lsqrt", "rsqrt", "s"]
CUTOFF_MODES = ["abs", "rel", "sum2", "rsum2", "sum1", "rsum1"]
# cutoffs that each drop some of the 12 values spaced from 1 to 1e-3
CUTOFFS = {"abs": 1e-2, "rel": 1e-2, "sum2": 1e-4, "rsum2": 1e-4,
           "sum1": 1e-2, "rsum1": 1e-2}


def _decaying(m, n, dtype, seed=0):
    """(m, n) matrix with singular values from 1 to 1e-3, log spaced."""
    rng = np.random.default_rng(seed)

    def r(shape):
        x = rng.standard_normal(shape)
        if dtype.startswith("complex"):
            x = x + 1j * rng.standard_normal(shape)
        return x

    k = min(m, n)
    U, _ = np.linalg.qr(r((m, k)))
    V, _ = np.linalg.qr(r((n, k)))
    return ((U * np.logspace(0, -3, k)) @ V.conj().T).astype(dtype)


def _hermitian(n, dtype, positive, seed=0):
    """Hermitian (n, n) with eigenvalues of distinct magnitudes, spaced
    from 1 to 1e-3, positive or of alternating sign."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    if dtype.startswith("complex"):
        x = x + 1j * rng.standard_normal((n, n))
    Q, _ = np.linalg.qr(x)
    ev = np.logspace(0, -3, n)
    if not positive:
        ev = ev * (-1) ** np.arange(n)
    return ((Q * ev) @ Q.conj().T).astype(dtype)


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _np(x):
    return None if x is None else (x.numpy() if isinstance(x, torch.Tensor)
                                   else np.asarray(x))


def _split_both(x, **kwargs):
    t = tuple(map(_np, tdecomp.array_split(torch.as_tensor(x), **kwargs)))
    j = tuple(map(_np, jdecomp.array_split(x, **kwargs)))
    return t, j


def _gauge_free(left, s, right):
    """The gauge-free content of one split's output."""
    if left is not None and right is not None:
        mid = np.diag(s) if s is not None else np.eye(left.shape[-1])
        return [left @ mid @ right]
    out = []
    if left is not None:
        out.append(left @ left.conj().T)
    if right is not None:
        out.append(right.conj().T @ right)
    if s is not None:
        out.append(s)
    return out


def _assert_same(t, j, tol=TOL):
    assert [x is None for x in t] == [x is None for x in j]
    for a, b in zip(t, j):
        if a is not None:
            assert a.shape == b.shape
    for a, b in zip(_gauge_free(*t), _gauge_free(*j)):
        assert _rel(a, b) < tol
    if t[1] is not None:
        assert _rel(t[1], j[1]) < TOL_S


def _svd_like_input(method, dtype, positive=True):
    """A (12, 16) matrix, or for ``eigh`` a hermitian (12, 12) one: positive
    where a mode takes square roots of the values, else indefinite."""
    if method == "eigh":
        return _hermitian(12, dtype, positive=positive)
    return _decaying(12, 16, dtype)


SVD_LIKE = ["svd", "svd:eig", "svd:rand", "eigh"]


def _opts(method):
    # svd:rand with max_bond + p >= min(m, n) sketches the whole range:
    # exact, whatever its random draw
    return {"max_bond": 6} if method == "svd:rand" else {}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("absorb", ABSORBS)
@pytest.mark.parametrize("method", SVD_LIKE)
def test_absorb_modes(method, absorb, dtype):
    x = _svd_like_input(method, dtype)
    t, j = _split_both(x, method=method, absorb=absorb, cutoff=1e-4,
                       cutoff_mode="rsum2", **_opts(method))
    _assert_same(t, j)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cutoff_mode", CUTOFF_MODES)
@pytest.mark.parametrize("method", SVD_LIKE)
def test_cutoff_modes(method, cutoff_mode, dtype):
    x = _svd_like_input(method, dtype, positive=False)
    t, j = _split_both(x, method=method, absorb=None,
                       cutoff=CUTOFFS[cutoff_mode], cutoff_mode=cutoff_mode,
                       **_opts(method))
    kept = t[1].shape[-1]
    assert 1 <= kept < 12 or method == "svd:rand"
    _assert_same(t, j)


@pytest.mark.parametrize("cutoff_mode", CUTOFF_MODES)
@pytest.mark.parametrize("renorm", [True, 1, 2])
def test_renorm(cutoff_mode, renorm):
    x = _decaying(12, 16, "float64")
    t, j = _split_both(x, absorb=None, cutoff=CUTOFFS[cutoff_mode],
                       cutoff_mode=cutoff_mode, renorm=renorm)
    _assert_same(t, j)


@pytest.mark.parametrize("max_bond", [1, 5, 12, 40])
def test_max_bond_and_cutoff(max_bond):
    x = _decaying(12, 16, "complex128")
    for cutoff in (-1.0, 0.0, 1e-4):
        t, j = _split_both(x, absorb="both", max_bond=max_bond,
                           cutoff=cutoff)
        _assert_same(t, j)


def test_info_error():
    x = _decaying(12, 16, "float64")
    ti, ji = {"error": None}, {"error": None}
    tdecomp.array_split(torch.as_tensor(x), max_bond=5, cutoff=0.0,
                        info=ti)
    jdecomp.array_split(x, max_bond=5, cutoff=0.0, info=ji)
    assert ti["error"] == pytest.approx(ji["error"], rel=TOL)
    assert ti["error"] > 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method,absorb,shape", [
    ("qr", "auto", (16, 12)), ("qr", "auto", (12, 16)),
    ("lq", "auto", (12, 16)), ("lq", "auto", (16, 12)),
    ("qr", "left", (12, 16)), ("qr:cholesky", "auto", (16, 12)),
    ("polar_right", "auto", (16, 12)), ("polar_left", "auto", (12, 16)),
    ("lu", "auto", (16, 12)), ("lu", "auto", (12, 16)),
])
def test_unique_factor_drivers(method, absorb, shape, dtype):
    x = _decaying(*shape, dtype)
    t, j = _split_both(x, method=method, absorb=absorb, cutoff=0.0)
    assert [a is None for a in t] == [a is None for a in j]
    for a, b in zip(t, j):
        if a is not None:
            assert a.shape == b.shape and _rel(a, b) < TOL
    assert _rel(t[0] @ t[2], x) < TOL


@pytest.mark.parametrize("dtype", DTYPES)
def test_cholesky_driver(dtype):
    x = _hermitian(10, dtype, positive=True)
    t, j = _split_both(x, method="cholesky")
    for a, b in zip(t, j):
        assert (a is None and b is None) or _rel(a, b) < TOL


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("positive", [0, 1])
@pytest.mark.parametrize("shift", [False, True])
def test_eigh_positive_and_shift(dtype, positive, shift):
    x = _hermitian(10, dtype, positive=True)
    t, j = _split_both(x, method="eigh", absorb=None, positive=positive,
                       shift=shift, cutoff=1e-6)
    _assert_same(t, j)


@pytest.mark.parametrize("cutoff_mode", ["abs", "rel"])
def test_lu_cutoff(cutoff_mode):
    # a rank-6 matrix: LU's last six columns of P L / rows of U vanish
    x = _decaying(12, 6, "float64") @ _decaying(6, 12, "float64", seed=1)
    t, j = _split_both(x, method="lu", cutoff=1e-8, cutoff_mode=cutoff_mode)
    assert t[0].shape == j[0].shape and t[0].shape[1] < 12
    assert _rel(t[0], j[0]) < TOL and _rel(t[2], j[2]) < TOL


@pytest.mark.parametrize("method,absorb", [
    ("auto", "both"), ("auto", "right"), ("auto", "left"), ("auto", None),
])
def test_auto_method(method, absorb):
    x = _decaying(12, 16, "float64")
    t, j = _split_both(x, method=method, absorb=absorb, cutoff=0.0)
    _assert_same(t, j)


@pytest.mark.parametrize("method", ["svd", "qr"])
@pytest.mark.parametrize("absorb", ["both", "right", "left"])
def test_numpy_backend_splits_on_the_host(method, absorb):
    x = _decaying(12, 16, "complex128")
    with tctr.contract_backend("numpy"):
        t = tdecomp.array_split(x, method=method, absorb=absorb,
                                cutoff=1e-4)
    assert all(isinstance(a, np.ndarray) for a in t if a is not None)
    j = tuple(map(_np, jdecomp.array_split(x, method=method, absorb=absorb,
                                           cutoff=1e-4)))
    _assert_same(t, j)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", ["qr", "svd", "mgs", "exp", "cayley",
                                    "householder"])
@pytest.mark.parametrize("shape", [(10, 6), (6, 6)])
def test_isometrize(method, shape, dtype):
    x = _decaying(*shape, dtype)
    t = tdecomp.isometrize(torch.as_tensor(x), method=method).numpy()
    j = np.asarray(jdecomp.isometrize(x, method=method))
    assert t.shape == j.shape and _rel(t, j) < TOL


def test_reduced_factor_and_oblique_projectors():
    x = _decaying(12, 8, "complex128")
    y = _decaying(8, 10, "complex128", seed=2)
    for right in (True, False):
        g = x.conj().T @ x if right else y @ y.conj().T
        R = tdecomp.squared_op_to_reduced_factor(torch.as_tensor(g),
                                                 right=right).numpy()
        back = R.conj().T @ R if right else R @ R.conj().T
        assert _rel(back, g) < TOL
    Rl = np.asarray(jdecomp.squared_op_to_reduced_factor(
        x.conj().T @ x, right=True))
    Rr = np.asarray(jdecomp.squared_op_to_reduced_factor(
        y @ y.conj().T, right=False))
    tPl, tPr = tdecomp.compute_oblique_projectors(
        torch.as_tensor(Rl), torch.as_tensor(Rr), max_bond=4, cutoff=0.0)
    jPl, jPr = jdecomp.compute_oblique_projectors(Rl, Rr, max_bond=4,
                                                  cutoff=0.0)
    P = tPl.numpy() @ tPr.numpy()
    assert _rel(P, np.asarray(jPl) @ np.asarray(jPr)) < TOL


@pytest.mark.parametrize("method", ["eigh", "svd"])
def test_similarity_compress(method):
    X = _hermitian(10, "float64", positive=True)
    tCl, tCr = tdecomp.similarity_compress(torch.as_tensor(X), 4,
                                           method=method)
    jCl, jCr = jdecomp.similarity_compress(X, 4, method=method)
    assert _rel(tCl.numpy() @ tCr.numpy(),
                np.asarray(jCl) @ np.asarray(jCr)) < TOL


def test_invalid_modes_raise():
    x = torch.as_tensor(_decaying(4, 4, "float64"))
    with pytest.raises(ValueError):
        tdecomp.array_split(x, absorb="sideways")
    with pytest.raises(ValueError):
        tdecomp.array_split(x, cutoff_mode="nope")
