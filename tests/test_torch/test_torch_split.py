"""quimb_torch's gram-matrix and subspace split drivers against quimb_tpu's,
in float64 on the CPU, on the same numpy inputs and the same random start.

quimb_tpu draws the start of its subspace iteration from
``jax.random.normal(PRNGKey(seed), ...)``, which torch cannot reproduce;
the port's drivers take it as ``omega``, so each test hands them
quimb_tpu's own draw. Singular vectors carry a sign gauge: the drivers
are compared through ``U @ VH``, the isometric side's projector, the
masked singular values and the rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quimb_tpu.ops import decomp as jdecomp
from quimb_tpu.tensor.tn1d import dmrg as jd
from quimb_torch.ops import decomp as tdecomp
from quimb_torch.tensor.tn1d import dmrg as td

# float64 LAPACK factorizations of matrices of a few dozen rows, whose
# kept singular values are at least 1e-3 of the largest (so the gram
# matrices' eigenvalues are well above eps): round-off level, relative
TOL = 1e-10


def jax_random_start(shape, dtype, device, seed):
    """quimb_tpu's draw ``jax.random.normal(PRNGKey(seed), shape)`` as a
    torch tensor: a stand-in for ``quimb_torch.ops.decomp._random_start``
    that makes the port follow quimb_tpu's random starts."""
    draw = jax.random.normal(jax.random.PRNGKey(seed), shape,
                             dtype=jnp.float64)
    return torch.as_tensor(np.array(draw), dtype=dtype, device=device)


def _decaying_matrix(rng, m, n):
    """Random (m, n) matrix with singular values from 1 down to 1e-3,
    evenly spaced in log."""
    k = min(m, n)
    U, _ = np.linalg.qr(rng.standard_normal((m, k)))
    V, _ = np.linalg.qr(rng.standard_normal((n, k)))
    return (U * np.logspace(0, -3, k)) @ V.T


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _assert_same_split(t, j, absorb):
    """t and j are (U, s, VH, rank) of the port and of quimb_tpu."""
    tU, ts, tVH, trank = t
    jU, js, jVH, jrank = j
    tU, tVH = tU.numpy(), tVH.numpy()
    jU, jVH = np.asarray(jU), np.asarray(jVH)
    assert int(trank) == int(jrank)
    assert tU.shape == jU.shape and tVH.shape == jVH.shape
    assert _rel(tU @ tVH, jU @ jVH) < TOL
    if absorb == "left":
        assert _rel(tVH.T @ tVH, jVH.T @ jVH) < TOL
    else:
        assert _rel(tU @ tU.T, jU @ jU.T) < TOL
    if js is not None:
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                                   atol=TOL)


SHAPES = [(12, 12), (14, 9), (9, 14)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("absorb", ["left", "right"])
@pytest.mark.parametrize("max_bond,cutoff", [(5, 0.0), (7, 1e-5),
                                             (-1, 1e-5)])
def test_svd_truncated_masked_eig(shape, absorb, max_bond, cutoff):
    x = _decaying_matrix(np.random.default_rng(1), *shape)
    kw = dict(max_bond=max_bond, cutoff=cutoff, cutoff_mode=4,
              absorb=absorb)
    j = jdecomp.svd_truncated_masked_eig(jnp.asarray(x), **kw)
    t = tdecomp.svd_truncated_masked_eig(torch.from_numpy(x), **kw)
    _assert_same_split(t, j, absorb)
    # and the same answer as the plain masked SVD
    s = tdecomp.svd_truncated_masked(torch.from_numpy(x), **kw)
    _assert_same_split(t, s, absorb)


def _omega(x, max_bond, oversample, absorb, seed=0):
    """quimb_tpu's start of the subspace iteration for x."""
    m, n = x.shape
    k = min(max_bond, m, n)
    kp = min(k + oversample, m, n)
    return jax_random_start((n if absorb == "left" else m, kp),
                            torch.float64, "cpu", seed)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("absorb", ["left", "right"])
@pytest.mark.parametrize("max_bond,cutoff", [(5, 0.0), (5, 1e-3),
                                             (12, 1e-5)])
def test_svd_truncated_masked_subspace(shape, absorb, max_bond, cutoff):
    """max_bond 12 >= min(m, n) takes the eig fallback."""
    x = _decaying_matrix(np.random.default_rng(2), *shape)
    kw = dict(max_bond=max_bond, cutoff=cutoff, cutoff_mode=4,
              absorb=absorb)
    j = jdecomp.svd_truncated_masked_subspace(jnp.asarray(x), **kw)
    t = tdecomp.svd_truncated_masked_subspace(
        torch.from_numpy(x), omega=_omega(x, max_bond, 8, absorb), **kw)
    _assert_same_split(t, j, absorb)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("absorb", ["left", "right"])
@pytest.mark.parametrize("max_bond,oversample", [(4, 0), (4, 8), (6, 2),
                                                 (20, 0)])
def test_split_truncated_subspace(shape, absorb, max_bond, oversample):
    """max_bond 20 >= min(m, n) takes the eig fallback."""
    x = _decaying_matrix(np.random.default_rng(3), *shape)
    kw = dict(max_bond=max_bond, absorb=absorb, oversample=oversample)
    jU, js, jVH, jrank = jdecomp.split_truncated_subspace(jnp.asarray(x),
                                                          **kw)
    t = tdecomp.split_truncated_subspace(
        torch.from_numpy(x), omega=_omega(x, max_bond, oversample, absorb),
        **kw)
    assert (t[1] is None) == (js is None)
    _assert_same_split(t, (jU, None, jVH, jrank), absorb)


def test_subspace_basis_default_start_is_repeatable():
    """Without ``omega`` the start comes from a generator seeded 0, drawn
    anew at each call: the same basis twice, spanning G's dominant
    eigenspace as well as the basis from quimb_tpu's start does."""
    x = torch.from_numpy(_decaying_matrix(np.random.default_rng(4), 16, 12))
    G = x @ x.T
    V1 = tdecomp._subspace_basis(G, 5, 2, x.dtype)
    V2 = tdecomp._subspace_basis(G, 5, 2, x.dtype)
    assert torch.equal(V1, V2)
    torch.testing.assert_close(V1.T @ V1, torch.eye(5, dtype=x.dtype),
                               rtol=0, atol=1e-13)
    U = torch.linalg.svd(x)[0][:, :5]
    # two rounds of subspace iteration from a random start: the top-5
    # subspace to about (s_6 / s_5)^4 ~ 0.3 in angle; compare the
    # captured weight of x instead, which is second order in the angle
    for V in (V1, tdecomp._subspace_basis(
            G, 5, 2, x.dtype, omega=jax_random_start((16, 5), x.dtype,
                                                     "cpu", 0))):
        captured = torch.linalg.norm(V.T @ x) / torch.linalg.norm(U.T @ x)
        assert 0.99 < captured.item() <= 1 + 1e-12


def test_safe_factorizations():
    rng = np.random.default_rng(5)
    for shape in [(7, 4), (4, 7), (5, 5), (3, 6, 4)]:
        x = rng.standard_normal(shape)
        tQ, tR = tdecomp.safe_qr(torch.from_numpy(x))
        jQ, jR = jdecomp.safe_qr(jnp.asarray(x))
        np.testing.assert_allclose((tQ @ tR).numpy(), x, atol=1e-13)
        np.testing.assert_allclose(np.abs(tR.numpy()), np.abs(np.asarray(jR)),
                                   atol=1e-13)
    h = rng.standard_normal((6, 6))
    h = h + h.T
    tw, tV = tdecomp.safe_eigh(torch.from_numpy(h))
    jw, jV = jdecomp.safe_eigh(jnp.asarray(h))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-13)
    np.testing.assert_allclose(np.abs(tV.numpy()), np.abs(np.asarray(jV)),
                               atol=1e-12)


@pytest.mark.parametrize("method,cutoff", [
    ("svd", 1e-6), ("svd:eig", 0.0), ("svd:eig", 1e-6), ("svd:sub", 1e-6),
    ("svd:sub", 0.0), ("svd:sub0", 0.0),
])
@pytest.mark.parametrize("absorb", ["left", "right"])
def test_split_2site_methods(monkeypatch, method, cutoff, absorb):
    """``_split_2site`` routes each method to its driver as quimb_tpu
    does, "svd:sub0" with no oversampling."""
    monkeypatch.setattr(tdecomp, "_random_start", jax_random_start)
    rng = np.random.default_rng(6)
    theta = _decaying_matrix(rng, 12, 10).reshape(6, 2, 2, 5)
    kw = dict(max_bond=4, cutoff=cutoff, absorb=absorb, method=method)
    jA1, jA2, jrank = jd._split_2site(jnp.asarray(theta), **kw)
    tA1, tA2, trank = td._split_2site(torch.from_numpy(theta), **kw)
    assert tuple(tA1.shape) == jA1.shape == (6, 2, 4)
    assert tuple(tA2.shape) == jA2.shape == (4, 2, 5)
    assert int(trank) == int(jrank)
    got = torch.einsum("kpc,cqr->kpqr", tA1, tA2).numpy()
    want = np.einsum("kpc,cqr->kpqr", np.asarray(jA1), np.asarray(jA2))
    assert _rel(got, want) < TOL


def test_split_2site_sub0_oversample():
    """The port's ``oversample`` takes the place of quimb_tpu's
    QUIMB_TPU_SUB0_OVERSAMPLE: with it the split is
    ``split_truncated_subspace`` with that padding."""
    theta = torch.from_numpy(
        _decaying_matrix(np.random.default_rng(7), 12, 10).reshape(6, 2, 2,
                                                                   5))
    A1, A2, _ = td._split_2site(theta, 4, 0.0, "right", method="svd:sub0",
                                oversample=3)
    U, _, VH, _ = tdecomp.split_truncated_subspace(
        theta.reshape(12, 10), max_bond=4, absorb="right", oversample=3)
    torch.testing.assert_close(A1.reshape(12, 4), U, rtol=0, atol=0)
    torch.testing.assert_close(A2.reshape(4, 10), VH, rtol=0, atol=0)
