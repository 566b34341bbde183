"""quimb_torch's one-site DMRG and the DMRG2 sweeps with the gram-matrix
and subspace splits, against quimb_tpu's, in float64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quimb_tpu.tensor as qtn
import quimb_torch
from quimb_torch.convert import from_tpu_mpo, from_tpu_mps
from quimb_torch.ops import cuda_kernels as ck
from quimb_torch.ops import decomp as tdecomp
from quimb_tpu.tensor.tn1d import dmrg as jd
from quimb_torch.tensor.tn1d import dmrg as td

from .test_torch_dmrg import E_EXACT_L10
from .test_torch_split import jax_random_start


def _t(*xs):
    return tuple(torch.from_numpy(np.asarray(x)) for x in xs)


def _random_site(rng, cl=5, cr=6, d=2, w=4):
    return (rng.normal(size=(cl, w, cl)), rng.normal(size=(w, w, d, d)),
            rng.normal(size=(cr, w, cr)), rng.normal(size=(cl, d, cr)))


def test_heff_matvec_and_overlap_norm_1site():
    rng = np.random.default_rng(20)
    L, W, R, theta = _random_site(rng)
    LW = np.einsum("awk,wxup->axupk", L, W)
    # float64 contractions of a few dozen terms: round-off level
    tol = dict(rtol=1e-12, atol=1e-12)
    want = np.asarray(jd._heff_matvec_1site(*map(jnp.asarray,
                                                  (LW, R, theta))))
    np.testing.assert_allclose(td._heff_matvec_1site(*_t(LW, R, theta)),
                               want, **tol)
    # the sandwich operands compute the same product
    A, B = td._sandwich_operands_1site(*_t(L, W, R))
    out = ck.sandwich_matvec(A, torch.from_numpy(theta).reshape(10, 6), B)
    np.testing.assert_allclose(out.reshape(theta.shape).numpy(), want, **tol)
    np.testing.assert_allclose(
        td._overlap_norm_1site(*_t(L, R, theta)).numpy(),
        np.asarray(jd._overlap_norm_1site(*map(jnp.asarray, (L, R, theta)))),
        **tol)


@pytest.mark.parametrize("norm_energy", [True, False])
def test_local_solve_1site(norm_energy):
    rng = np.random.default_rng(21)
    L, W, R, theta0 = _random_site(rng)
    # hermitian environments and MPO, so the effective Hamiltonian is
    L = L + L.transpose(2, 1, 0)
    R = R + R.transpose(2, 1, 0)
    W = W + W.transpose(0, 1, 3, 2)
    kw = dict(ncv=8, restarts=2, norm_energy=norm_energy)
    j_en, j_v = jd._local_solve_1site(*map(jnp.asarray, (L, W, R, theta0)),
                                      **kw)
    calls = []

    def prepare(a, b):
        calls.append((a.shape, b.shape))
        return ck.prepare_sandwich_reference(a, b)

    t_en, t_v = td._local_solve_1site(*_t(L, W, R, theta0), sandwich=prepare,
                                      **kw)
    # one prepared operand set per solve, K2 = N = r
    assert calls == [((4, 10, 10), (4, 6, 6))]
    # two restarts of 8 Lanczos vectors in float64 on one operator:
    # round-off level, amplified a little by the restart; the Ritz vector
    # carries an overall sign from each side's eigh
    np.testing.assert_allclose(float(t_en), float(j_en), rtol=1e-10)
    j_v = np.asarray(j_v)
    t_v = t_v.numpy() * np.sign(np.vdot(t_v.numpy(), j_v))
    np.testing.assert_allclose(t_v, j_v, atol=1e-8)


def _dmrg2_state(L, chi, seed, sweeps):
    """quimb_tpu DMRG2 from a random state after ``sweeps`` right sweeps
    at ``chi``: (H, its state as an MPS)."""
    H = qtn.MPO_ham_heis(L)
    d2 = qtn.DMRG2(H, bond_dims=chi, cutoffs=0.0,
                   p0=qtn.MPS_rand_state(L, chi, seed=seed))
    for _ in range(sweeps):
        d2.sweep("R", max_bond=chi, cutoff=0.0)
    return H, d2.state


def _dmrg1_pair(H, psi, chi, ncv=4):
    """quimb_tpu's and the port's DMRG1 from one state, both with Lanczos
    bases of ``ncv`` vectors. The default 4 is the dimension of the
    one-site space at a chain end, (1, d, d): quimb_tpu builds its
    default basis of 8 vectors there past the space, and the spurious
    Ritz values of the rounding-noise vectors then reach its sweep
    energies (far below the ground energy). The port caps the basis at
    the space's dimension; at 4 both run the same algorithm."""
    jdmrg = qtn.DMRG1(H, bond_dims=chi, cutoffs=0.0, p0=psi)
    tdmrg = quimb_torch.DMRG1(from_tpu_mpo(H, device="cpu"), bond_dims=chi,
                              cutoffs=0.0, p0=from_tpu_mps(psi, device="cpu"))
    for dmrg in (jdmrg, tdmrg):
        dmrg.opts["local_eig_ncv"] = ncv // 2
        dmrg.opts["local_eig_ncv_floor"] = ncv
    return jdmrg, tdmrg


@pytest.mark.parametrize("L,chi,sweeps", [(10, 32, 4), (12, 6, 1)])
def test_dmrg1_sweeps(L, chi, sweeps):
    """DMRG1 from a DMRG2 state: at L=10, chi=32 the converged exact
    ground state, which DMRG1 keeps; at L=12, chi=6 a state one sweep
    from random, which DMRG1 improves at a fixed bond dimension."""
    H, psi = _dmrg2_state(L, chi, seed=7, sweeps=sweeps)
    jdmrg, tdmrg = _dmrg1_pair(H, psi, chi)
    assert tdmrg.bsz == 1
    for direction, canonize in [("R", True), ("L", False), ("R", False),
                                ("R", True), ("L", False)]:
        kw = dict(max_bond=chi, cutoff=0.0, canonize=canonize)
        j_en = jdmrg.sweep(direction, **kw)
        t_en = tdmrg.sweep(direction, **kw)
        # float64 Lanczos and QR / LQ on the same state: the sign gauge
        # of the factorizations does not reach the energies
        assert abs(t_en - j_en) < 1e-9
        assert len(tdmrg.local_energies[-1]) == L
    assert [tuple(A.shape) for A in td._mps_uniform_arrays(tdmrg.state)] \
        == [jdmrg._A[i].shape for i in range(L)]
    if L == 10:
        assert abs(t_en - E_EXACT_L10) < 1e-8


def test_dmrg1_default_basis_stays_variational():
    """With the default basis of 8 vectors, which is larger than the
    chain ends' one-site space of dimension 4, the port's DMRG1 keeps the
    converged L=10 state's exact energy: no sweep energy falls below the
    ground energy."""
    H, psi = _dmrg2_state(10, 32, seed=7, sweeps=4)
    dmrg = quimb_torch.DMRG1(from_tpu_mpo(H, device="cpu"), bond_dims=32,
                             cutoffs=0.0, p0=from_tpu_mps(psi, device="cpu"))
    for direction, canonize in [("R", True), ("L", False), ("R", False)]:
        en = dmrg.sweep(direction, max_bond=32, cutoff=0.0,
                        canonize=canonize)
        # float64 round-off of a converged state; a spurious Ritz value
        # would sit tens of units below
        assert abs(en - E_EXACT_L10) < 1e-8
        assert min(float(e) for e in dmrg.local_energies[-1]) > \
            E_EXACT_L10 - 1e-9


def test_dmrg1_solve():
    """``solve`` of DMRG1, from the L=10 state one sweep from random."""
    H, psi = _dmrg2_state(10, 16, seed=8, sweeps=1)
    jdmrg, tdmrg = _dmrg1_pair(H, psi, 16)
    kw = dict(tol=1e-10, sweep_sequence="RL", max_sweeps=6)
    assert jdmrg.solve(**kw) == tdmrg.solve(**kw)
    np.testing.assert_allclose(tdmrg.energies, jdmrg.energies, atol=1e-9)
    assert abs(tdmrg.energy - E_EXACT_L10) < 1e-6


def test_dmrg1_calls_the_1site_solve(monkeypatch):
    """A DMRG1 sweep runs the one-site solve at every site and never the
    two-site one."""
    H = quimb_torch.MPO_ham_heis(6, device="cpu")
    dmrg = quimb_torch.DMRG1(H, bond_dims=4,
                             p0=quimb_torch.MPS_rand_state(6, 4, seed=1,
                                                           device="cpu"))
    calls = {"1site": 0}
    solve_1site = td._local_solve_1site

    def counted(*args, **kwargs):
        calls["1site"] += 1
        return solve_1site(*args, **kwargs)

    def fail(*args, **kwargs):
        raise AssertionError("two-site solve in a one-site sweep")

    monkeypatch.setattr(td, "_local_solve_1site", counted)
    monkeypatch.setattr(td, "_local_solve_2site", fail)
    dmrg.sweep("R", max_bond=4)
    dmrg.sweep("L", max_bond=4)
    assert calls["1site"] == 12
    with pytest.raises(ValueError):
        td.DMRG(H, bond_dims=4, bsz=3)


def _dmrg2_pair(L, chi, seed, method):
    H = qtn.MPO_ham_heis(L)
    p0 = qtn.MPS_rand_state(L, chi, seed=seed)
    jdmrg = qtn.DMRG2(H, bond_dims=chi, cutoffs=0.0, p0=p0)
    tdmrg = quimb_torch.DMRG2(from_tpu_mpo(H, device="cpu"), bond_dims=chi,
                              cutoffs=0.0, p0=from_tpu_mps(p0, device="cpu"))
    for dmrg in (jdmrg, tdmrg):
        dmrg.opts["bond_compress_method"] = method
    return jdmrg, tdmrg


@pytest.mark.parametrize("method", ["svd:eig", "svd:sub"])
@pytest.mark.parametrize("cutoff", [1e-10, 0.0])
def test_dmrg2_split_methods(monkeypatch, method, cutoff):
    """DMRG2 sweeps with the gram-matrix and subspace splits, from one
    start state and with quimb_tpu's random start of the subspace
    iteration; "svd:sub" at cutoff 0 runs as "svd:sub0". At L=12, chi=8
    every bulk bond truncates 16 values to 8."""
    monkeypatch.setattr(tdecomp, "_random_start", jax_random_start)
    monkeypatch.delenv("QUIMB_TPU_SUB0_OVERSAMPLE", raising=False)
    jdmrg, tdmrg = _dmrg2_pair(12, 8, seed=9, method=method)
    used = []
    split = td._split_2site

    def spy(*args, **kwargs):
        used.append(kwargs["method"])
        return split(*args, **kwargs)

    monkeypatch.setattr(td, "_split_2site", spy)
    want = "svd:sub0" if (method, cutoff) == ("svd:sub", 0.0) else method
    for direction, canonize in [("R", True), ("L", False), ("R", False),
                                ("L", False)]:
        kw = dict(max_bond=8, cutoff=cutoff, canonize=canonize)
        j_en = jdmrg.sweep(direction, **kw)
        t_en = tdmrg.sweep(direction, **kw)
        if want != "svd:sub0":
            # float64 sweeps of 11 truncating splits each from one state
            # and one random start: round-off, amplified through 44 splits
            assert abs(t_en - j_en) < 1e-9
    # "svd:sub0" iterates twice from the random start with no
    # oversampling, in a bond basis whose column signs come from each
    # package's LAPACK eigh / QR and differ between them; its kept
    # subspace then differs too. Both take near-optimal truncations:
    # 1e-3 apart after the first sweep, a few 1e-8 after four
    assert abs(t_en - j_en) < 1e-6
    assert set(used) == {want}
    # chi=8 at L=12 is within 1e-3 of the exact ground energy
    assert -5.15 < t_en < -5.14
