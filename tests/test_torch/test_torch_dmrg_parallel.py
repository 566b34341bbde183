"""quimb_torch's segment-parallel DMRG engine against quimb_tpu's, in
float64 on the CPU, on the same numpy inputs.

quimb_tpu's batched split draws its start from
``jax.random.normal(PRNGKey(23), ...)``; the port draws from a torch
generator seeded 23, so the tests that follow quimb_tpu step by step
hand the port quimb_tpu's draw (as ``Om``, or through
``decomp._random_start``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import quimb_tpu as q
import quimb_tpu.tensor as qtn
import quimb_torch
from quimb_torch.convert import from_tpu_mpo, from_tpu_mps
from quimb_torch.ops import cuda_kernels as ck
from quimb_torch.ops import decomp as tdecomp
from quimb_tpu.tensor.tn1d import dmrg as jd
from quimb_tpu.tensor.tn1d import dmrg_jacobi as jj
from quimb_tpu.tensor.tn1d import dmrg_parallel as jp
from quimb_torch.tensor.tn1d import core as tc
from quimb_torch.tensor.tn1d import dmrg_jacobi as tj
from quimb_torch.tensor.tn1d import dmrg_parallel as tp

from .test_torch_split import jax_random_start

# float64 contractions and LAPACK factorizations of well-conditioned
# matrices of a few dozen rows: round-off level, relative
TOL = 1e-10


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@functools.lru_cache(maxsize=None)
def _converged(L, chi):
    """quimb_tpu's converged DMRG2 state of the Heisenberg chain: (H,
    dmrg), shared by the tests, which only read it."""
    H = qtn.MPO_ham_heis(L)
    dmrg = qtn.DMRG2(H, bond_dims=[8, 16, chi], cutoffs=1e-10)
    dmrg.solve(tol=1e-9, verbosity=0)
    return H, dmrg


def _port_objects(H, psi):
    """quimb_tpu's MPO and MPS carried across: (the port's MPO, MPS)."""
    return from_tpu_mpo(H, device="cpu"), from_tpu_mps(psi, device="cpu")


def _uniform(x):
    """The uniform site arrays of an MPS or MPO of either package, or a
    list of them as it is."""
    if isinstance(x, tc.MatrixProductState):
        return tc._mps_uniform_arrays(x)
    if isinstance(x, tc.MatrixProductOperator):
        return tc._mpo_uniform_arrays(x)
    if isinstance(x, qtn.MatrixProductState):
        return jd._mps_uniform_arrays(x)
    if isinstance(x, qtn.MatrixProductOperator):
        return jd._mpo_uniform_arrays(x)
    return x


def _host_energy(psi, H):
    """⟨ψ|H|ψ⟩/⟨ψ|ψ⟩ of the state psi under the MPO H, in float64
    numpy."""
    env, nrm = np.ones((1, 1, 1)), np.ones((1, 1))
    for A, W in zip(_uniform(psi), _uniform(H)):
        A, W = _np(A), _np(W)
        env = np.einsum("bwk,kdx,wyud,bua->ayx", env, A, W, A.conj(),
                        optimize=True)
        nrm = np.einsum("bk,kdx,bda->ax", nrm, A, A.conj(), optimize=True)
    return float(env.reshape(())) / float(nrm.reshape(()))


def _exact_e(L):
    return spla.eigsh(q.ham_heis(L, sparse=True), k=1, which="SA")[0][0]


def _random_stack(L, chi, seed):
    """A random state padded to chi: (quimb_tpu stack, port stack, the
    state)."""
    psi = quimb_torch.MPS_rand_state(L, chi, seed=seed, dtype=torch.float64,
                                     device="cpu")
    Ms = tj.mps_to_stack(psi, chi)
    return jnp.asarray(Ms.numpy()), Ms, psi


# -- stacks and masks ----------------------------------------------------------


@pytest.mark.parametrize("L,chi,d", [(8, 4, 2), (16, 24, 2), (6, 50, 3),
                                     (70, 8, 2)])
def test_bond_rank_masks(L, chi, d):
    want = jp.bond_rank_masks(L, chi, d, dtype=np.float64)
    got = tp.bond_rank_masks(L, chi, d, dtype=torch.float64)
    np.testing.assert_array_equal(got.numpy(), want)


def test_stack_converters():
    H, dmrg = _converged(10, 16)
    psi = dmrg.state
    tH, tpsi = _port_objects(H, psi)
    # a stack wider than the state's bonds: the padding is trimmed
    Ms = tj.mps_to_stack(tpsi, 20)
    np.testing.assert_array_equal(Ms.numpy(), np.asarray(jj.mps_to_stack(psi,
                                                                        20)))
    np.testing.assert_array_equal(tj.mpo_to_padded_stack(tH).numpy(),
                                  jj.mpo_to_padded_stack(H))
    back = tj.stack_to_mps(Ms, tpsi)
    assert isinstance(back, tc.MatrixProductState)
    assert back.site_tags == tpsi.site_tags
    for A, B in zip(_uniform(back), _uniform(tpsi)):
        np.testing.assert_array_equal(A.numpy(), B.numpy())
    # quimb_tpu's rule on a stack with a dead inner column: the bond keeps
    # as many columns as are alive, counted from the first
    Ms[4, :, :, 1] = 0.0
    Ms[5, 1] = 0.0
    want = jd._mps_uniform_arrays(jj.stack_to_mps(jnp.asarray(Ms.numpy()),
                                                  psi))
    got = _uniform(tj.stack_to_mps(Ms, tpsi))
    assert [tuple(A.shape) for A in got] == [A.shape for A in want]
    for A, B in zip(got, want):
        np.testing.assert_array_equal(A.numpy(), np.asarray(B))
    with pytest.raises(ValueError):
        tj.mps_to_stack(tpsi, 8)


def test_batched_tridiag_eigvec():
    rng = np.random.default_rng(30)
    alpha, beta = rng.normal(size=(3, 8)), rng.normal(size=(3, 8))
    jw, jv = jj._batched_tridiag_eigvec(jnp.asarray(alpha), jnp.asarray(beta))
    tw, tv = tj._batched_tridiag_eigvec(torch.from_numpy(alpha),
                                        torch.from_numpy(beta))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-12)
    sign = np.sign(np.sum(tv.numpy() * np.asarray(jv), axis=-1))
    np.testing.assert_allclose(tv.numpy() * sign[:, None], np.asarray(jv),
                               atol=1e-12)


# -- canonize passes -----------------------------------------------------------


def test_canonize_passes():
    """Both passes on one random state (full rank at every bond, so the
    sign-fixed QR and LQ are unique and well conditioned)."""
    L, chi = 12, 16
    jMs, tMs, tpsi = _random_stack(L, chi, seed=31)
    H = qtn.MPO_ham_heis(L)
    jWs = jj.mpo_to_padded_stack(H)
    tWs = torch.from_numpy(jWs)
    jm = jp.bond_rank_masks(L, chi, dtype=np.float64)
    tm = tp.bond_rank_masks(L, chi, dtype=torch.float64)
    jB, jR = jp._canonize_right_and_renvs(jMs, jnp.asarray(jWs), jm)
    tB, tR = tp._canonize_right_and_renvs(tMs, tWs, tm)
    assert _rel(tB, jB) < TOL and _rel(tR, jR) < TOL
    jA, jLe, jRp = jp._canonize_left_and_lenvs(jB, jnp.asarray(jWs), jm)
    tA, tLe, tRp = tp._canonize_left_and_lenvs(tB, tWs, tm)
    for t, j in ((tA, jA), (tLe, jLe), (tRp, jRp)):
        assert t.shape == j.shape and _rel(t, j) < TOL
    # the passes' environments and the gauge between them give the
    # state's energy at every bond
    e = _host_energy(tj.stack_to_mps(tMs, tpsi),
                     quimb_torch.MPO_ham_heis(L, dtype=torch.float64,
                                              device="cpu"))
    for j in range(L - 1):
        R = tRp[j + 1]
        got = (torch.einsum("awk,kr,ab,bwr->", tLe[j], R, R, tR[j + 1])
               / torch.einsum("ab,ab->", R, R))
        assert abs(got.item() - e) < 1e-10 * abs(e)


# -- batched solve and split ---------------------------------------------------


def _random_segments(rng, S, chi, d=2, w=5):
    """Hermitian boundary environments and MPO tensors for S segments,
    and a start th0."""
    def herm_env():
        x = rng.normal(size=(S, chi, w, chi))
        return x + x.transpose(0, 3, 2, 1)

    def herm_mpo():
        x = rng.normal(size=(S, w, w, d, d))
        return x + x.transpose(0, 1, 2, 4, 3)

    return (herm_env(), herm_mpo(), herm_mpo(), herm_env(),
            rng.normal(size=(S, chi, d, d, chi)))


def test_sandwich_stacks_and_matvec():
    """The segments' sandwich operands compute the einsum pair of both
    packages."""
    rng = np.random.default_rng(32)
    S, chi, d, w = 2, 6, 2, 5
    LW1 = rng.normal(size=(S, chi, w, d, d, chi))
    W2R = rng.normal(size=(S, w, d, d, chi, chi))
    th = rng.normal(size=(S, chi, d, d, chi))
    want = np.asarray(jj._batched_matvec(*map(jnp.asarray, (LW1, W2R, th))))
    t = [torch.from_numpy(x) for x in (LW1, W2R, th)]
    np.testing.assert_allclose(tj._batched_matvec(*t).numpy(), want,
                               rtol=1e-12, atol=1e-12)
    A, B = tp._sandwich_stacks(t[0], t[1])
    heffs = [ck.prepare_sandwich(A[i], B[i]) for i in range(S)]
    got = tp._matvec_via_sandwich(heffs, t[2].reshape(S, chi * d, d * chi))
    np.testing.assert_allclose(got.reshape(want.shape).numpy(), want,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("damp", [1.0, 0.5])
def test_batched_solve_2site(damp):
    rng = np.random.default_rng(33)
    S, chi = 3, 5
    ops = _random_segments(rng, S, chi)
    j_en, j_th = jp._batched_solve_2site(*map(jnp.asarray, ops), ncv=8,
                                         damp=damp)
    calls = []

    def prepare(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return ck.prepare_sandwich_reference(a, b)

    t_en, t_th = tp._batched_solve_2site(
        *map(torch.from_numpy, ops), ncv=8, damp=damp, sandwich=prepare)
    # one prepared operand set per segment: A (w, a*u, k*p), B (w, q*r, v*b)
    assert calls == [((5, 10, 10), (5, 10, 10))] * S
    # 8 Lanczos vectors in float64 on one operator: round-off level; the
    # Ritz vector carries an overall sign from each side's eigh (damping
    # aligns it with the start on both)
    np.testing.assert_allclose(t_en.numpy(), np.asarray(j_en), rtol=1e-10)
    j_th = np.asarray(j_th)
    sign = np.sign(np.sum((t_th.numpy() * j_th).reshape(S, -1), axis=-1))
    np.testing.assert_allclose(t_th.numpy() * sign[:, None, None, None,
                                                   None], j_th, atol=1e-8)


@pytest.mark.parametrize("absorb", ["left", "right"])
@pytest.mark.parametrize("oversample", [0, 3])
def test_batched_split_2site(absorb, oversample):
    rng = np.random.default_rng(34)
    S, chi, d, k = 2, 6, 2, 5
    # a decaying spectrum, so that two rounds of subspace iteration
    # resolve the kept subspace well
    U, _ = np.linalg.qr(rng.normal(size=(S, chi * d, chi * d)))
    V, _ = np.linalg.qr(rng.normal(size=(S, chi * d, chi * d)))
    th = ((U * np.logspace(0, -4, chi * d)) @ V.transpose(0, 2, 1)).reshape(
        S, chi, d, d, chi)
    jA1, jA2 = jp._batched_split_2site(jnp.asarray(th), k, absorb,
                                       oversample=oversample)
    Om = jax_random_start((chi * d, k + oversample), torch.float64, "cpu", 23)
    tA1, tA2 = tp._batched_split_2site(torch.from_numpy(th), k, absorb,
                                       oversample=oversample, Om=Om)
    assert tA1.shape == jA1.shape == (S, chi, d, k)
    assert tA2.shape == jA2.shape == (S, k, d, chi)
    prod = "nkpc,ncqr->nkpqr"
    assert _rel(torch.einsum(prod, tA1, tA2),
                np.einsum(prod, np.asarray(jA1), np.asarray(jA2))) < TOL
    # the isometric side's projector
    if absorb == "right":
        t, j = tA1.reshape(S, -1, k).numpy(), np.asarray(jA1).reshape(S, -1, k)
        proj = "nik,njk->nij"
    else:
        t, j = tA2.reshape(S, k, -1).numpy(), np.asarray(jA2).reshape(S, k, -1)
        proj = "nki,nkj->nij"
    assert _rel(np.einsum(proj, t, t), np.einsum(proj, j, j)) < TOL
    # the default start: a generator seeded 23, the same at every call
    a = tp._batched_split_2site(torch.from_numpy(th), k, absorb,
                                oversample=oversample)
    b = tp._batched_split_2site(torch.from_numpy(th), k, absorb,
                                oversample=oversample)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# -- whole outer sweeps --------------------------------------------------------


def test_parallel_sweeps_match_quimb_tpu(monkeypatch):
    """Four outer sweeps (two of them offset) at L=16, chi=24, S=2 from a
    state one DMRG2 sweep from random, carried across: quimb_tpu's and
    the port's energies, and their final states' energies, agree."""
    monkeypatch.setattr(tdecomp, "_random_start", jax_random_start)
    monkeypatch.delenv("QUIMB_TPU_PAR_PALLAS", raising=False)
    L, chi = 16, 24
    H = qtn.MPO_ham_heis(L)
    seed = qtn.DMRG2(H, bond_dims=[8], cutoffs=1e-10,
                     p0=qtn.MPS_rand_state(L, 8, seed=35))
    seed.sweep("R", max_bond=8, cutoff=1e-10)
    tH, tpsi = _port_objects(H, seed.state)
    jpd = jp.ParallelDMRG(seed.state, H, max_bond=chi, n_segments=2)
    tpd = tp.ParallelDMRG(tpsi, tH, max_bond=chi, n_segments=2)
    for _ in range(4):
        j_en, t_en = jpd.sweep(), tpd.sweep()
        # float64 sweeps of 21 batched solves and splits each from one
        # state and one random start: round-off, amplified a little by
        # the sweeps
        assert abs(t_en - j_en) < 1e-8
    want = _host_energy(jpd.get_state(), H)
    assert abs(_host_energy(tpd.get_state(), tH) - want) < 1e-8


def test_whole_chain_segment_matches_sequential():
    """S=1 is a fixed-boundary sweep of the whole chain."""
    L = 8
    H, dmrg = _converged(L, 12)
    tH, tpsi = _port_objects(H, dmrg.state)
    pd = tp.ParallelDMRG(tpsi, tH, max_bond=12, n_segments=1)
    assert pd.sweep() == pytest.approx(_exact_e(L), abs=1e-5)


def test_fixed_point_stability():
    """30 outer sweeps at the converged state keep its energy (naive
    parallel updates diverge within a few sweeps)."""
    L = 16
    H, dmrg = _converged(L, 24)
    tH, tpsi = _port_objects(H, dmrg.state)
    pd = tp.ParallelDMRG(tpsi, tH, max_bond=24, n_segments=2)
    for _ in range(30):
        pd.sweep()
    assert _host_energy(pd.get_state(), tH) == pytest.approx(
        float(dmrg.energy), abs=1e-6)


def test_converges_from_rough_seed():
    """One low-bond DMRG2 sweep, then parallel sweeps alone reach the
    chi-limited optimum."""
    L = 16
    H = quimb_torch.MPO_ham_heis(L, dtype=torch.float64, device="cpu")
    dmrg = quimb_torch.DMRG2(H, bond_dims=8, cutoffs=1e-10,
                             p0=quimb_torch.MPS_rand_state(
                                 L, 8, seed=36, dtype=torch.float64,
                                 device="cpu"))
    dmrg.sweep("R", max_bond=8, cutoff=1e-10)
    pd = tp.ParallelDMRG(dmrg.state, H, max_bond=24, n_segments=2)
    for _ in range(25):
        pd.sweep()
    assert _host_energy(pd.get_state(), H) == pytest.approx(_exact_e(L),
                                                           abs=1e-6)


def test_inner_passes_and_checks():
    L = 16
    H, dmrg = _converged(L, 24)
    tH, tpsi = _port_objects(H, dmrg.state)
    pd = tp.ParallelDMRG(tpsi, tH, max_bond=24, n_segments=2, inner_passes=2)
    for _ in range(4):
        en = pd.sweep()
    assert en == pytest.approx(float(dmrg.energy), abs=1e-6)
    assert len(pd.energies) == 4
    with pytest.raises(ValueError):
        tp.ParallelDMRG(tpsi, tH, max_bond=24, n_segments=3)
