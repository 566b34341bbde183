"""quimb_torch's Jacobi DMRG engine (``tensor/tn1d/dmrg_jacobi.py``:
``_nenv_step_*``, ``_chol_and_inv``, ``_jacobi_halfsweep``,
``_renormalize_stack``, ``JacobiDMRG``) against quimb_tpu's, in float64
on the CPU.

Both packages start from one state: quimb_tpu's DMRG2 result carried
across by ``convert.from_tpu_mps``. quimb_tpu draws the randomized
subspace start from ``jax.random.normal(PRNGKey(17 + parity))``; the port
takes the same matrix through ``omega=``. Ritz energies and the products
of the updated site pairs are gauge-free up to the sign of each bond's
Ritz vector (``eigh`` and QR sign their columns differently in
LAPACK-through-JAX and torch); they match to 1e-10, a Lanczos of eight
matvecs and a few small factorisations on O(1) numbers. quimb_tpu's results are cached: each jitted half-sweep
compiles for a few seconds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quimb_torch
import quimb_tpu.tensor as jtn
from quimb_torch import convert
from quimb_torch.tensor.tn1d import dmrg_jacobi as tj
from quimb_tpu.tensor.tn1d import dmrg_jacobi as jj

CPU = "cpu"
TOL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: small batched factorisations, which threads only
    slow down on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(None)
def _converged(L, chi):
    """quimb_tpu's MPO and converged DMRG2 state of the L-site Heisenberg
    chain at bond ``chi``, with its energy (the helper of quimb_tpu's own
    test, tests/test_tensor/test_dmrg_parallel.py)."""
    H = jtn.MPO_ham_heis(L)
    d = jtn.DMRG2(H, bond_dims=[8, 16, chi], cutoffs=1e-10)
    d.solve(tol=1e-9, verbosity=0)
    return H, d.state, float(d.energy)


def _stacks(L, chi):
    """Both packages' padded stacks (Ms, Ws) of the same state."""
    H, psi, _ = _converged(L, chi)
    Msj = jj.mps_to_stack(psi, chi)
    Wsj = jnp.asarray(jj.mpo_to_padded_stack(H))
    Mst = tj.mps_to_stack(convert.from_tpu_mps(psi, device=CPU), chi)
    Wst = tj.mpo_to_padded_stack(convert.from_tpu_mpo(H, device=CPU))
    return (Msj, Wsj), (Mst, Wst)


def _omega(chi, d, max_bond, parity, oversample=16):
    """quimb_tpu's subspace start of a half-sweep of ``parity``."""
    kp = min(max_bond + oversample, chi * d)
    return np.asarray(jax.random.normal(jax.random.PRNGKey(17 + parity),
                                        (chi * d, kp), jnp.float64))


def _spd_batch(n=6, k=3, dead=(), seed=0):
    """A batch of k hermitian positive-definite n x n matrices; the
    directions in ``dead`` are zeroed, as a padded bond's are."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(k, n, n))
    N = X @ X.transpose(0, 2, 1) + 0.1 * np.eye(n)
    for i in dead:
        N[:, i, :] = N[:, :, i] = 0.0
    return N


@pytest.mark.parametrize("dead", [(), (4, 5)])
def test_chol_and_inv_matches(dead):
    N = _spd_batch(dead=dead)
    Cj, Cij = (np.asarray(x) for x in jj._chol_and_inv(jnp.asarray(N)))
    Ct, Cit = (x.numpy() for x in tj._chol_and_inv(torch.from_numpy(N), 0))
    # a Cholesky of 6 x 6 matrices of O(1) entries
    np.testing.assert_allclose(Ct, Cj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(Cit, Cij, rtol=0, atol=1e-12)
    np.testing.assert_allclose(Ct @ Cit, np.broadcast_to(np.eye(6), N.shape),
                               rtol=0, atol=1e-12)
    # a dead direction gets a unit diagonal (and the 8 eps tr shift)
    for i in dead:
        np.testing.assert_allclose(Ct[:, i, i], 1.0, rtol=0, atol=1e-12)


def test_chol_and_inv_raises_naming_the_parity():
    """An indefinite norm environment: quimb_tpu's Cholesky returns NaN,
    the port raises and names the parity and the batch entry."""
    N = _spd_batch(k=2)
    N[1] -= 50.0 * np.eye(6)
    assert np.isnan(np.asarray(jj._chol_and_inv(jnp.asarray(N))[0][1])).any()
    with pytest.raises(torch.linalg.LinAlgError, match=r"parity 1, batch "
                                                       r"entries \[1\]"):
        tj._chol_and_inv(torch.from_numpy(N), 1)


@pytest.mark.parametrize("step", ["_nenv_step_right", "_nenv_step_left"])
@pytest.mark.parametrize("cplx", [False, True])
def test_nenv_steps_match(step, cplx):
    rng = np.random.default_rng(1)
    N = rng.normal(size=(5, 5))
    M = rng.normal(size=(5, 2, 5))
    if cplx:
        N = N + 1j * rng.normal(size=(5, 5))
        M = M + 1j * rng.normal(size=(5, 2, 5))
    want = np.asarray(getattr(jj, step)(jnp.asarray(N), jnp.asarray(M)))
    got = getattr(tj, step)(torch.from_numpy(N), torch.from_numpy(M))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@functools.lru_cache(None)
def _jax_halfsweep(L, chi, parity):
    (Msj, Wsj), _ = _stacks(L, chi)
    Mj, ej = jj._jacobi_halfsweep(Msj, Wsj, parity=parity, ncv=8,
                                  max_bond=chi)
    return np.asarray(Mj), np.asarray(ej)


@pytest.mark.parametrize("parity", [0, 1])
def test_halfsweep_matches(parity):
    L, chi = 8, 8
    Mj, ej = _jax_halfsweep(L, chi, parity)
    _, (Mst, Wst) = _stacks(L, chi)
    Mt, et = tj._jacobi_halfsweep(Mst, Wst, parity, 8, chi,
                                  omega=_omega(chi, 2, chi, parity))
    np.testing.assert_allclose(et.numpy(), ej, rtol=0, atol=TOL)
    Mt = Mt.numpy()
    for i in range(parity, L - 1, 2):
        # a product carries its Ritz vector's sign, which each library's
        # eigh chooses
        got = np.einsum("kpc,cqr->kpqr", Mt[i], Mt[i + 1])
        want = np.einsum("kpc,cqr->kpqr", Mj[i], Mj[i + 1])
        np.testing.assert_allclose(np.sign(np.vdot(got, want)) * got, want,
                                   rtol=0, atol=TOL)
    # the sites outside the parity's bonds are untouched
    touched = {j for i in range(parity, L - 1, 2) for j in (i, i + 1)}
    for j in set(range(L)) - touched:
        np.testing.assert_array_equal(Mt[j], Mst[j].numpy())


def test_halfsweep_default_start_is_seeded():
    """With no ``omega`` the start comes from a generator seeded
    17 + parity: two calls agree bitwise, and the energies equal those
    of the given start to the subspace's resolution."""
    L, chi = 8, 8
    _, (Mst, Wst) = _stacks(L, chi)
    a = tj._jacobi_halfsweep(Mst, Wst, 0, 8, chi)
    b = tj._jacobi_halfsweep(Mst, Wst, 0, 8, chi)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    _, ej = _jax_halfsweep(L, chi, 0)
    np.testing.assert_allclose(a[1].numpy(), ej, rtol=0, atol=TOL)


def test_renormalize_stack_matches():
    L, chi = 8, 8
    Mj, _ = _jax_halfsweep(L, chi, 0)
    want = np.asarray(jj._renormalize_stack(jnp.asarray(Mj)))
    got = tj._renormalize_stack(torch.from_numpy(Mj)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # unit norm: <psi|psi> of the renormalised stack is 1
    NL = np.zeros((chi, chi))
    NL[0, 0] = 1.0
    for M in got:
        NL = np.einsum("ak,kdx,ady->yx", NL, M, M)
    assert NL[0, 0] == pytest.approx(1.0, abs=1e-12)


def _true_energy(psi, H):
    """<psi|H|psi> / <psi|psi> of the port's MPS under its MPO, by a sweep
    in numpy."""
    from quimb_torch.tensor.tn1d import dmrg as td

    As = [A.numpy() for A in td._mps_uniform_arrays(psi)]
    Ws = [W.numpy() for W in td._mpo_uniform_arrays(H)]
    env, nrm = np.ones((1, 1, 1)), np.ones((1, 1))
    for A, W in zip(As, Ws):
        env = np.einsum("bwk,kdx,wyud,bua->ayx", env, A, W, A.conj(),
                        optimize=True)
        nrm = np.einsum("bk,kdx,bda->ax", nrm, A, A.conj(), optimize=True)
    return float(env.reshape(())) / float(nrm.reshape(()))


def test_fixed_point_holds_with_damped_solves():
    """quimb_tpu's own test of the engine (TestJacobiDMRG) on the port:
    from a converged L=16, chi=24 DMRG2 state (its helper's schedule),
    15 sweeps with ncv=2 keep the energy within 1e-6 of the start."""
    H = quimb_torch.MPO_ham_heis(16, device=CPU)
    d = quimb_torch.DMRG2(H, bond_dims=[8, 16, 24], cutoffs=1e-10)
    d.solve(tol=1e-9, verbosity=0)
    jd = tj.JacobiDMRG(d.state, H, max_bond=24, ncv=2)
    for _ in range(15):
        jd.sweep()
    state = jd.get_state()
    assert all(t.data.device.type == "cpu" for t in state)
    assert _true_energy(state, H) == pytest.approx(float(d.energy),
                                                   abs=1e-6)


@functools.lru_cache(None)
def _jax_sweeps(L, chi, n):
    H, psi, _ = _converged(L, chi)
    jd = jj.JacobiDMRG(psi, H, max_bond=chi)
    return [jd.sweep() for _ in range(n)]


def test_sweep_energies_match():
    """Three sweeps at quimb_tpu's defaults, the subspace starts shared:
    the mean Ritz energies agree sweep by sweep. The states differ by the
    gauge of each factorisation, which the whitening absorbs, and by
    rounding, which the brickwork iteration amplifies from sweep to sweep
    (the third sweeps were 3.8e-9 and 5.4e-9 apart in two runs): 1e-7."""
    L, chi = 10, 8
    H, psi, _ = _converged(L, chi)
    want = _jax_sweeps(L, chi, 3)
    jd = tj.JacobiDMRG(convert.from_tpu_mps(psi, device=CPU),
                       convert.from_tpu_mpo(H, device=CPU), max_bond=chi,
                       omega={p: _omega(chi, 2, chi, p) for p in (0, 1)})
    got = [jd.sweep() for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert jd.energies == got

