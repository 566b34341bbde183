"""quimb_torch's split drivers against quimb_tpu's, on the same numpy
inputs. Singular vectors carry a sign gauge, so the truncated SVD is
compared through gauge-free quantities; QR and LQ fix their signs and are
compared factor by factor."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quimb_tpu.ops import decomp as jdecomp
from quimb_torch.ops import decomp as tdecomp


def _graded_matrix(rng, m, n):
    """Random (m, n) matrix with singular values 1, 0.1, 0.01, ... so that
    every cutoff mode cuts somewhere inside the spectrum."""
    k = min(m, n)
    U, _ = np.linalg.qr(rng.standard_normal((m, k)))
    V, _ = np.linalg.qr(rng.standard_normal((n, k)))
    return (U * np.logspace(0, -(k - 1), k)) @ V.T


@pytest.mark.parametrize("absorb", [None, "both", "left", "right"])
@pytest.mark.parametrize("cutoff_mode,cutoff", [
    (1, 2e-4), (2, 2e-4), (4, 1e-7),
])
@pytest.mark.parametrize("max_bond", [6, -1])
def test_svd_truncated_masked(absorb, cutoff_mode, cutoff, max_bond):
    x = _graded_matrix(np.random.default_rng(3), 12, 9)
    jU, js, jVH, jrank = jdecomp.svd_truncated_masked(
        jnp.asarray(x), max_bond=max_bond, cutoff=cutoff,
        cutoff_mode=cutoff_mode, absorb=absorb,
    )
    tU, ts, tVH, trank = tdecomp.svd_truncated_masked(
        torch.from_numpy(x), max_bond=max_bond, cutoff=cutoff,
        cutoff_mode=cutoff_mode, absorb=absorb,
    )
    jU, js, jVH = map(np.asarray, (jU, js, jVH))
    tU, ts, tVH = tU.numpy(), ts.numpy(), tVH.numpy()
    assert int(trank) == int(jrank)
    assert 1 <= int(trank) < min(x.shape)
    assert tU.shape == jU.shape and tVH.shape == jVH.shape
    # float64 LAPACK factorisations of a 12 x 9 matrix: round-off level
    tol = dict(rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(ts, js, **tol)
    np.testing.assert_allclose(tU @ tU.T, jU @ jU.T, **tol)
    np.testing.assert_allclose(tVH.T @ tVH, jVH.T @ jVH, **tol)
    np.testing.assert_allclose(tU @ tVH, jU @ jVH, **tol)


def test_svd_truncated_masked_renorm():
    x = _graded_matrix(np.random.default_rng(4), 8, 8)
    kw = dict(max_bond=5, cutoff=1e-5, cutoff_mode=4, renorm=1,
              absorb=None)
    _, js, _, _ = jdecomp.svd_truncated_masked(jnp.asarray(x), **kw)
    _, ts, _, _ = tdecomp.svd_truncated_masked(torch.from_numpy(x), **kw)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-10)


@pytest.mark.parametrize("shape", [(8, 5), (5, 8), (6, 6)])
def test_qr_stabilized(shape):
    x = np.random.default_rng(5).standard_normal(shape)
    jQ, _, jR = jdecomp.qr_stabilized(jnp.asarray(x))
    tQ, _, tR = tdecomp.qr_stabilized(torch.from_numpy(x))
    # signs are fixed (R's diagonal positive): the factors agree to
    # round-off
    np.testing.assert_allclose(tQ.numpy(), np.asarray(jQ), atol=1e-12)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-12)
    assert np.all(np.diagonal(tR.numpy()) > 0)


@pytest.mark.parametrize("shape", [(8, 5), (5, 8), (6, 6)])
def test_lq_stabilized(shape):
    x = np.random.default_rng(6).standard_normal(shape)
    jL, _, jQ = jdecomp.lq_stabilized(jnp.asarray(x))
    tL, _, tQ = tdecomp.lq_stabilized(torch.from_numpy(x))
    np.testing.assert_allclose(tL.numpy(), np.asarray(jL), atol=1e-12)
    np.testing.assert_allclose(tQ.numpy(), np.asarray(jQ), atol=1e-12)
    np.testing.assert_allclose(tL.numpy() @ tQ.numpy(), x, atol=1e-12)


def test_mode_maps():
    assert tdecomp.CUTOFF_MODE_MAP == jdecomp.CUTOFF_MODE_MAP
    for alias in jdecomp._ABSORB_ALIASES:
        assert tdecomp.parse_absorb(alias) == jdecomp.parse_absorb(alias)
    with pytest.raises(ValueError):
        tdecomp.parse_absorb("sideways")


def test_small_helpers():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 4)) + 1j * rng.standard_normal((3, 4))
    d4, d3 = rng.standard_normal(4), rng.standard_normal(3)
    tx = torch.from_numpy(x)
    pairs = [
        (tdecomp.dag(tx), jdecomp.dag(jnp.asarray(x))),
        (tdecomp.rdmul(tx, torch.from_numpy(d4)),
         jdecomp.rdmul(jnp.asarray(x), jnp.asarray(d4))),
        (tdecomp.ldmul(torch.from_numpy(d3), tx),
         jdecomp.ldmul(jnp.asarray(d3), jnp.asarray(x))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.resolve_conj().numpy(),
                                   np.asarray(want), rtol=1e-15)
    v = np.array([0.0, -2.0, 3.0, 1j])
    np.testing.assert_allclose(tdecomp.sgn(torch.from_numpy(v)).numpy(),
                               np.asarray(jdecomp.sgn(jnp.asarray(v))))


def _masked_rank(s, cutoff, cutoff_mode):
    eye = torch.eye(s.shape[-1], dtype=s.dtype)
    _, s_out, _, rank = tdecomp._truncate_mask_absorb(
        eye, s, eye, max_bond=-1, cutoff=cutoff, cutoff_mode=cutoff_mode,
        renorm=0, absorb=None)
    return int(rank), s_out


def test_float32_mask_keeps_the_weight_above_the_cutoff():
    """A float32 spectrum whose s^2 spans 1e10: at cutoff 0 the mask keeps
    every nonzero value (quimb_tpu's, whose float32 prefix sums reach the
    total early, keeps a fraction), and at random cutoffs of every mode it
    keeps as many as a float64 mask of the same values."""
    rng = np.random.default_rng(21)
    s = np.sort(10 ** rng.uniform(-5, 0, 200))[::-1].astype(np.float32)
    s32 = torch.as_tensor(s)
    rank, s_out = _masked_rank(s32, 0.0, 4)
    assert rank == 200 and bool((s_out > 0).all())
    eye = jnp.eye(200, dtype=jnp.float32)
    jrank = int(jdecomp._truncate_mask_absorb(
        eye, jnp.asarray(s), eye, max_bond=-1, cutoff=0.0, cutoff_mode=4,
        renorm=0, absorb=None)[3])
    assert jrank < 200
    s64 = s32.double()
    for cutoff_mode in (1, 2, 3, 4, 5, 6):
        for cutoff in 10 ** rng.uniform(-12, -1, 10):
            assert _masked_rank(s32, cutoff, cutoff_mode)[0] == \
                _masked_rank(s64, cutoff, cutoff_mode)[0]
    # the zeros past a spectrum's rank go, the first value always stays
    assert _masked_rank(torch.tensor([2.0, 1.0, 0.0, 0.0]), 0.0, 4)[0] == 2
    assert _masked_rank(torch.zeros(3), 0.5, 4)[0] == 1


def test_complex_svd_redo_counts(monkeypatch):
    """The checked gesvdj's control flow, with the cuSOLVER call stubbed:
    a convergence failure is redone by gesvd and counted, in complex128
    for a complex64 input too; a second failure raises."""
    calls = []

    def svd_call(x, driver):
        calls.append((x.dtype, driver))
        if driver == "gesvdj":
            raise torch.linalg.LinAlgError("gesvdj failed to converge")
        return torch.linalg.svd(x, full_matrices=False)

    monkeypatch.setattr(tdecomp, "_svd_call", svd_call)
    x = torch.as_tensor(np.random.default_rng(22).standard_normal((4, 3)),
                        dtype=torch.complex64)
    before = dict(tdecomp.SVD_REDOS)
    U, s, VH = tdecomp._checked_gesvdj(x)
    assert calls == [(torch.complex128, "gesvdj"),
                     (torch.complex128, "gesvd")]
    assert tdecomp.SVD_REDOS == {**before,
                                 torch.complex64: before[torch.complex64] + 1}
    assert U.dtype == torch.complex128
    # no driver on the CPU: LAPACK's default, unchecked
    assert tdecomp._svd_driver(x) is None
    monkeypatch.setattr(tdecomp, "_svd_call", lambda x, driver: (
        _ for _ in ()).throw(torch.linalg.LinAlgError("no convergence")))
    with pytest.raises(torch.linalg.LinAlgError):
        tdecomp._checked_gesvdj(x)
