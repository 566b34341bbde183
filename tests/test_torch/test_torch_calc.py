"""quimb_torch's ``calc.py`` against quimb_tpu's, on the CPU: fidelities,
purification, channels, projectors and measurement (the same
``default_rng(seed)`` draws), entropies, mutual information, negativities,
concurrence, discord, the decompositions and correlations. Inputs are
``np.random.default_rng`` states of 6-8 qubits in complex128; quantities
agree to 1e-10 absolute (spectra of O(1) matrices by LAPACK on both
sides; the discord's COBYLA runs on the host in both, 1e-8)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quimb_tpu.calc as jcalc
import quimb_tpu.core as jcore
from quimb_torch import calc as tcalc
from quimb_torch import core as tcore

TOL = 1e-10


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _ket(rng, d):
    k = rng.standard_normal((d, 1)) + 1j * rng.standard_normal((d, 1))
    return k / np.linalg.norm(k)


def _rho(rng, d, rank=3):
    X = rng.standard_normal((d, rank)) + 1j * rng.standard_normal((d, rank))
    r = X @ X.conj().T
    return r / np.trace(r)


def _same(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(_np(got), dtype=complex),
                               np.asarray(want, dtype=complex), rtol=0,
                               atol=tol)


def test_fidelity_purify_channels():
    rng = np.random.default_rng(0)
    a, b = _ket(rng, 8), _ket(rng, 8)
    r1, r2 = _rho(rng, 8), _rho(rng, 8)
    for x, y in ((a, b), (a, r1), (r1, b), (r1, r2)):
        for sq in (False, True):
            _same(tcalc.fidelity(_t(x), _t(y), squared=sq),
                  jcalc.fidelity(jnp.asarray(x), jnp.asarray(y),
                                 squared=sq), tol=1e-8)
    p = tcalc.purify(_t(r1))
    _same(tcore.ptr(p, (8, 8), 0), r1, tol=1e-12)
    _same(tcalc.dephase(_t(r1), 0.3), jcalc.dephase(r1, 0.3))
    E = [np.sqrt(0.7) * np.eye(2), np.sqrt(0.3) * np.diag([1, -1])]
    _same(tcalc.kraus_op(_t(r1), np.stack(E), dims=(2, 2, 2), where=1),
          jcalc.kraus_op(r1, np.stack(E), dims=(2, 2, 2), where=1))
    _same(tcalc.kraus_op(_t(r1), np.kron(np.eye(4), E[1])),
          jcalc.kraus_op(r1, np.kron(np.eye(4), E[1])))


def test_projector_measure_and_counts():
    rng = np.random.default_rng(1)
    A = np.diag([1.0, 1.0, -1.0, 0.5]) + 0j
    U = np.linalg.qr(rng.standard_normal((4, 4)))[0]
    A = U @ A @ U.T
    _same(tcalc.projector(_t(A), 1.0), jcalc.projector(A, 1.0), tol=1e-12)
    k, r = _ket(rng, 4), _rho(rng, 4)
    for p in (k, r):
        for kw in (dict(seed=3), dict(eigenvalue=-1.0), dict(seed=11)):
            lt, pt = tcalc.measure(_t(p), _t(A), **kw)
            lj, pj = jcalc.measure(jnp.asarray(p), A, **kw)
            assert lt == pytest.approx(float(lj), abs=1e-12)
            if np.shape(p)[1] == 1:
                _same(tcore.dop(pt), jcore.dop(pj), tol=1e-10)
            else:
                _same(pt, pj, tol=1e-10)
    psi = _ket(rng, 16)
    assert tcalc.simulate_counts(_t(psi), 50, seed=7) == \
        jcalc.simulate_counts(psi, 50, seed=7)
    r16 = _rho(rng, 16)
    assert tcalc.simulate_counts(_t(r16), 30, seed=2) == \
        jcalc.simulate_counts(r16, 30, seed=2)


def test_entropies_and_mutual_information():
    rng = np.random.default_rng(2)
    dims = (2,) * 7
    psi = _ket(rng, 2**7)
    # full rank: a square root turns rounding-level eigenvalues of two
    # LAPACKs (1e-17 apart) into 1e-9 differences
    r = _rho(rng, 8, rank=8)
    assert tcalc.entropy(_t(r)) == pytest.approx(jcalc.entropy(r), abs=TOL)
    w = np.array([0.5, 0.25, 0.25, 0.0])
    assert tcalc.entropy(_t(w)) == pytest.approx(jcalc.entropy(w), abs=TOL)
    for sysa in ((0, 1), (2, 3, 4, 5), 6, (0, 3, 6)):
        assert tcalc.entropy_subsys(_t(psi), dims, sysa) == pytest.approx(
            jcalc.entropy_subsys(jnp.asarray(psi), dims, sysa), abs=TOL)
    for p in (psi, _rho(rng, 2**4, rank=4)):
        d = (2,) * int(np.log2(p.shape[0]))
        assert tcalc.mutinf(_t(p), d, (0, 1)) == pytest.approx(
            jcalc.mutinf(jnp.asarray(p), d, (0, 1)), abs=TOL)
    assert tcalc.mutinf_subsys(_t(psi), dims, (0, 1), (4, 5)) == \
        pytest.approx(jcalc.mutinf_subsys(jnp.asarray(psi), dims, (0, 1),
                                          (4, 5)), abs=TOL)
    assert tcalc.schmidt_gap(_t(psi), dims, (0, 1, 2)) == pytest.approx(
        jcalc.schmidt_gap(jnp.asarray(psi), dims, (0, 1, 2)), abs=TOL)
    assert tcalc.tr_sqrt(_t(r)) == pytest.approx(jcalc.tr_sqrt(r), abs=TOL)
    assert tcalc.tr_sqrt_subsys(_t(psi), dims, (1, 2)) == pytest.approx(
        jcalc.tr_sqrt_subsys(jnp.asarray(psi), dims, (1, 2)), abs=TOL)
    # past approx_thresh the entropy goes to stochastic Lanczos quadrature
    # (the port's own probes): within its tolerance of the exact value
    exact = tcalc.entropy_subsys(_t(psi), dims, (0, 1, 2))
    approx = tcalc.entropy_subsys(_t(psi), dims, (0, 1, 2), approx_thresh=4,
                                  tol=0.02, seed=3)
    assert approx == pytest.approx(exact, abs=0.1)


def test_negativities_and_concurrence():
    rng = np.random.default_rng(3)
    dims = (2,) * 6
    psi = _ket(rng, 2**6)
    r = _rho(rng, 16, rank=2)
    for sysa in (0, (0, 2), (1, 2, 3)):
        _same(tcalc.partial_transpose(_t(r), (2, 2, 2, 2), sysa),
              jcalc.partial_transpose(r, (2, 2, 2, 2), sysa), tol=0)
        for fn in ("partial_transpose_norm", "logneg", "negativity"):
            assert getattr(tcalc, fn)(_t(r), (2, 2, 2, 2), sysa) == \
                pytest.approx(getattr(jcalc, fn)(r, (2, 2, 2, 2), sysa),
                              abs=TOL)
    for sa, sb in (((0, 1), (3, 4)), ((1,), (2, 5)), (0, 5)):
        assert tcalc.logneg_subsys(_t(psi), dims, sa, sb) == pytest.approx(
            jcalc.logneg_subsys(jnp.asarray(psi), dims, sa, sb), abs=TOL)
    r2, k2 = _rho(rng, 4, rank=4), _ket(rng, 4)
    for p in (r2, k2):
        assert tcalc.concurrence(_t(p)) == pytest.approx(
            jcalc.concurrence(jnp.asarray(p)), abs=TOL)
    a, b = _rho(rng, 4), _rho(rng, 4)
    assert tcalc.trace_distance(_t(a), _t(b)) == pytest.approx(
        jcalc.trace_distance(a, b), abs=TOL)
    k3 = _ket(rng, 4)
    assert tcalc.trace_distance(_t(k2), _t(k3)) == pytest.approx(
        jcalc.trace_distance(k2, k3), abs=TOL)


def test_discord_and_classical_information():
    rng = np.random.default_rng(4)
    r = _rho(rng, 4, rank=2)
    prj = [np.diag([1.0, 0.0]), np.diag([0.0, 1.0])]
    assert tcalc.one_way_classical_information(_t(r), prj) == \
        pytest.approx(jcalc.one_way_classical_information(
            jnp.asarray(r), prj), abs=TOL)
    assert tcalc.quantum_discord(_t(r)) == pytest.approx(
        jcalc.quantum_discord(jnp.asarray(r)), abs=1e-8)


def test_decompositions_and_correlations(capsys):
    rng = np.random.default_rng(5)
    r = _rho(rng, 4)
    k = _ket(rng, 16)
    for fn in ("pauli_decomp", "bell_decomp"):
        got = getattr(tcalc, fn)(_t(r), mode="c")
        want = getattr(jcalc, fn)(jnp.asarray(r), mode="c")
        assert list(got) == list(want)
        assert list(got.values()) == pytest.approx(list(want.values()),
                                                   abs=1e-12)
    tcalc.pauli_decomp(_t(k), mode="p")
    out_t = capsys.readouterr().out
    jcalc.pauli_decomp(jnp.asarray(k), mode="p")
    assert out_t == capsys.readouterr().out
    for p in (k, _rho(rng, 16)):
        X = np.array([[0, 1], [1, 0]])
        Z = np.array([[1, 0], [0, -1]])
        assert tcalc.correlation(_t(p), X, Z, 0, 2) == pytest.approx(
            jcalc.correlation(jnp.asarray(p), X, Z, 0, 2), abs=TOL)
        got = tcalc.pauli_correlations(_t(p), sysa=1, sysb=3)
        want = jcalc.pauli_correlations(jnp.asarray(p), sysa=1, sysb=3)
        assert list(got) == pytest.approx([float(w) for w in want],
                                          abs=TOL)
        f = tcalc.pauli_correlations(_t(p), sum_abs=True, precomp_func=True)
        assert f(_t(p)) == pytest.approx(float(jcalc.pauli_correlations(
            jnp.asarray(p), sum_abs=True)), abs=TOL)
    np.testing.assert_allclose(tcalc.ent_cross_matrix(_t(k)),
                               jcalc.ent_cross_matrix(jnp.asarray(k)),
                               atol=TOL)
    np.testing.assert_allclose(
        tcalc.ent_cross_matrix(_t(k), sz_blc=2, calc_self_ent=False),
        jcalc.ent_cross_matrix(jnp.asarray(k), sz_blc=2,
                               calc_self_ent=False), atol=TOL)
    np.testing.assert_allclose(tcalc.qid(_t(k), (2,) * 4, (0, 2)),
                               jcalc.qid(jnp.asarray(k), (2,) * 4, (0, 2)),
                               atol=TOL)
    tcalc.cprint(_t(k[:4]))
    out_t = capsys.readouterr().out
    jcalc.cprint(k[:4])
    assert out_t == capsys.readouterr().out


def test_spectral_predicates_and_closed_forms():
    rng = np.random.default_rng(6)
    A = np.diag([0.0, 1.0, 1.0, 2.0, 2.0, 2.0]) + 0j
    assert tcalc.is_degenerate(_t(A)) == jcalc.is_degenerate(A) == 3
    assert tcalc.is_degenerate([1.0, 2.0, 3.0]) == 0
    v = np.eye(6)[:, 1:2]
    assert tcalc.is_eigenvector(_t(v), _t(A)) == \
        jcalc.is_eigenvector(v, A) is True
    assert not tcalc.is_eigenvector(_t(_ket(rng, 6)), _t(A))
    for a, b in ((2, 16), (8, 64), (16, 256)):
        assert tcalc.page_entropy(a, b) == pytest.approx(
            jcalc.page_entropy(a, b), abs=1e-14)
    assert tcalc.heisenberg_energy(64) == jcalc.heisenberg_energy(64)
