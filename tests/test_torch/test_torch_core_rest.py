"""The rest of quimb_torch's ``core.py`` against quimb_tpu's, on the CPU:
the predicates, ``bra`` / ``dop`` / ``chop`` / ``normalize``,
``expectation``, the traces, ``dim_compress`` / ``dim_map``, ``kronpow``,
``ikron`` / ``pkron`` / ``permute`` and ``partial_trace``, on the same
``np.random.default_rng`` inputs in complex128. Tolerances are 1e-12
absolute (products of O(1) entries); a partial trace of 13 qubits merges
its runs of sites first, so that no reshape has one axis a site."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import quimb_tpu.core as jc
from quimb_torch import core as tc

CPU = "cpu"


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _rand(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _herm(rng, d):
    X = _rand(rng, d, d)
    return (X + X.conj().T) / 2


def test_predicates_and_quantum_objects():
    rng = np.random.default_rng(0)
    ket, op = _rand(rng, 8, 1), _herm(rng, 8)
    for x in (ket, ket.T, op, np.ones(3), 2.0):
        for name in ("isket", "isbra", "isop", "isvec", "isscalarish"):
            assert getattr(tc, name)(_t(x) if np.ndim(x) else x) == \
                getattr(jc, name)(jnp.asarray(x) if np.ndim(x) else x)
    assert tc.isherm(_t(op)) and not tc.isherm(_t(_rand(rng, 4, 4)))
    assert tc.isherm(sp.csr_matrix(op)) == jc.isherm(sp.csr_matrix(op))
    assert tc.isreal(_t(op.real)) and not tc.isreal(_t(op))
    pos = op @ op.conj().T
    assert tc.ispos(_t(pos)) == jc.ispos(pos) is True
    assert tc.ispos(_t(op)) == jc.ispos(op)
    assert tc.issparse(sp.eye(3)) and tc.isdense(_t(op))
    assert tc.make_immutable(3) == 3
    for qtype in ("ket", "bra", "dop"):
        got = tc.quimbify(ket[:, 0], qtype=qtype, normalized=True,
                          device=CPU)
        want = jc.quimbify(ket[:, 0], qtype=qtype, normalized=True)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-14)
    np.testing.assert_allclose(_np(tc.bra(ket, device=CPU)),
                               np.asarray(jc.bra(ket)), atol=0)
    np.testing.assert_allclose(_np(tc.dop(ket, device=CPU)),
                               np.asarray(jc.dop(ket)), atol=1e-14)
    s = tc.quimbify(op, sparse=True, device=CPU)
    assert sp.issparse(s) and np.allclose(s.toarray(), op)
    x = np.array([[1.0, 1e-17], [3.0, -2e-16]])
    np.testing.assert_array_equal(_np(tc.chop(_t(x))),
                                  np.asarray(jc.chop(x)))
    np.testing.assert_allclose(_np(tc.quimbify(x, chopped=True,
                                               device=CPU)),
                               np.asarray(jc.quimbify(x, chopped=True)))
    assert tc.infer_size(_t(ket)) == jc.infer_size(ket) == 3
    with pytest.raises(ValueError):
        tc.infer_size(torch.ones(6, 1))
    assert sp.issparse(tc.sparse_matrix(op)) and sp.issparse(tc.speye(3))
    np.testing.assert_allclose(_np(tc.eye(3, device=CPU)), np.eye(3))


def test_products_norms_and_expectations():
    rng = np.random.default_rng(1)
    a, b = _rand(rng, 6, 1), _rand(rng, 6, 1)
    A, B = _herm(rng, 6), _herm(rng, 6)
    d = rng.standard_normal(6)
    pairs = [
        (tc.vdot(_t(a), _t(b)), jc.vdot(a, b)),
        (tc.rdot(_t(a), _t(b)), jc.rdot(a, b)),
        (tc.ldmul(_t(d), _t(A)), jc.ldmul(d, A)),
        (tc.rdmul(_t(A), _t(d)), jc.rdmul(A, d)),
        (tc.outer(_t(a), _t(b)), jc.outer(a, b)),
        (tc.explt(_t(d), 0.3), jc.explt(d, 0.3)),
        (tc.mul(_t(A), _t(B)), jc.mul(A, B)),
        (tc.dot(_t(A), _t(B)), jc.dot(A, B)),
        (tc.normalize(_t(a)), jc.normalize(a)),
        (tc.normalize(_t(A @ A)), jc.normalize(A @ A)),
        (tc.tr(_t(A)), jc.tr(A)),
        (tc.dag(_t(A @ B)), jc.dag(A @ B)),
    ]
    for x, y in ((a, b), (A, b), (a, B), (A, B)):
        pairs.append((tc.expectation(_t(x), _t(y)), jc.expectation(x, y)))
    for got, want in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=1e-12)
    m = tc.mul(sp.csr_matrix(A), _np(B))
    np.testing.assert_allclose(np.asarray(m.todense()), A * B, atol=1e-12)
    T = _rand(rng, 3, 4, 3, 4)
    for axes in ((0, 2), ((0, 1), (2, 3)), ((1,), (3,))):
        np.testing.assert_allclose(_np(tc.itrace(_t(T), axes)),
                                   np.asarray(jc.itrace(T, axes)),
                                   atol=1e-12)


def test_dim_compress_and_dim_map():
    cases = [((2, 3, 4, 5, 6), (1, 2)), ((2,) * 8, (0, 3, 4, 7)),
             ((2, 2, 2), 1), ((4, 4), ())]
    for dims, inds in cases:
        assert tc.dim_compress(dims, inds) == jc.dim_compress(dims, inds)
    for args in (([[2, 3], [4, 5]], [(0, 1), (1, 0)]),
                 (np.full((3, 4), 2), [(1, 2), (4, 5)], True),
                 (np.full((3, 4), 2), [(1, 2), (4, 5)], False, True),
                 ([2, 3, 4], [0, 2])):
        assert tc.dim_map(*args) == jc.dim_map(*args)
    with pytest.raises(ValueError):
        tc.dim_map([2, 2], [(3,)])
    q = tc.qarray([[1, 2], [3, 4j]])
    assert np.array_equal(q.H, jc.qarray([[1, 2], [3, 4j]]).H)
    assert repr(q).startswith("qarray")


def test_kron_ikron_pkron_permute():
    rng = np.random.default_rng(2)
    A, B, C = _herm(rng, 2), _herm(rng, 4), _herm(rng, 2)
    dims = (2, 2, 2, 2, 2)
    np.testing.assert_allclose(
        _np(tc.kronpow(_t(A), 3)), np.asarray(jc.kronpow(A, 3)), atol=1e-12)
    for ops, inds in (((A,), (2,)), ((A, C), (0, 3)), (B, (1,)),
                      ((A, B), (0, 3)), (A, (1, 3))):
        t_ops = tuple(_t(o) for o in ops) if isinstance(ops, tuple) \
            else _t(ops)
        np.testing.assert_allclose(_np(tc.ikron(t_ops, dims, inds)),
                                   np.asarray(jc.ikron(ops, dims, inds)),
                                   atol=1e-12)
    got = tc.ikron(sp.csr_matrix(A), dims, 2)
    assert sp.issparse(got)
    np.testing.assert_allclose(got.toarray(),
                               np.asarray(jc.ikron(A, dims, 2)), atol=1e-12)
    for inds in ((3, 1), (4, 0), (1, 2)):
        np.testing.assert_allclose(_np(tc.pkron(_t(B), dims, inds)),
                                   np.asarray(jc.pkron(B, dims, inds)),
                                   atol=1e-12)
    psi, rho = _rand(rng, 2 * 3 * 4 * 2, 1), _herm(rng, 2 * 3 * 4 * 2)
    dims = (2, 3, 4, 2)
    for perm in ((3, 2, 1, 0), (1, 2, 0, 3), (0, 1, 2, 3), (2, 3, 0, 1)):
        for p in (psi, rho):
            np.testing.assert_allclose(_np(tc.permute(_t(p), dims, perm)),
                                       np.asarray(jc.permute(p, dims, perm)),
                                       atol=0)


@pytest.mark.parametrize("keep", [(0,), (2, 3), (0, 4, 5), (1, 3, 5),
                                  (5,), (0, 1, 2, 3, 4, 5)])
def test_partial_trace(keep):
    rng = np.random.default_rng(3)
    dims = (2, 3, 2, 2, 3, 2)
    d = int(np.prod(dims))
    psi = _rand(rng, d, 1)
    psi /= np.linalg.norm(psi)
    X = _rand(rng, d, 4)
    rho = X @ X.conj().T
    for p in (psi, rho):
        got = tc.partial_trace(_t(p), dims, keep)
        np.testing.assert_allclose(_np(got),
                                   np.asarray(jc.partial_trace(p, dims,
                                                               keep)),
                                   atol=1e-12)
    assert tc.ptr is tc.partial_trace


def test_partial_trace_of_thirteen_qubits():
    """A 13-qubit density operator (26 axes one a site in quimb_tpu's
    reshape): two kept sites far apart, against the ket's reduced state."""
    rng = np.random.default_rng(4)
    n = 13
    psi = _rand(rng, 2**n, 1)
    psi /= np.linalg.norm(psi)
    keep = (2, 9)
    want = np.asarray(jc.partial_trace(psi, (2,) * n, keep))
    rho = _t(psi) @ _t(psi).conj().T
    got = tc.partial_trace(rho, (2,) * n, keep)
    np.testing.assert_allclose(_np(got), want, atol=1e-12)
