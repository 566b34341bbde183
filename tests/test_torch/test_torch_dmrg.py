"""quimb_torch's DMRG2 slice against quimb_tpu's, in float64 on the CPU:
the builders, the per-bond kernels, one local update on the inputs of
``__graft_entry__.entry()``, and whole sweeps from the same start
state."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quimb_tpu.tensor as qtn
import quimb_torch
from __graft_entry__ import entry
from quimb_tpu.tensor.tn1d import dmrg as jd
from quimb_torch.convert import from_tpu_mpo, from_tpu_mps, to_numpy
from quimb_torch.tensor.tn1d import dmrg as td

# exact ground energy of the open spin-1/2 Heisenberg chain of 10 sites
E_EXACT_L10 = -4.258035207282883


def _t(*xs):
    return tuple(torch.from_numpy(np.asarray(x)) for x in xs)


@pytest.mark.parametrize("L,kw", [
    (2, {}),
    (5, {}),
    (12, {}),
    (6, {"j": (1.0, 0.5, 0.3), "bz": 0.2}),
    (6, {"S": 1}),
])
def test_mpo_ham_heis_matches(L, kw):
    want = jd._mpo_uniform_arrays(qtn.MPO_ham_heis(L, **kw))
    got = td._mpo_uniform_arrays(quimb_torch.MPO_ham_heis(L, **kw,
                                                        device="cpu"))
    assert len(got) == L
    for g, w in zip(to_numpy(got), want):
        w = np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_mps_rand_state():
    L, chi = 14, 8
    want = jd._mps_uniform_arrays(qtn.MPS_rand_state(L, chi, seed=1))
    got = td._mps_uniform_arrays(
        quimb_torch.MPS_rand_state(L, chi, seed=1, device="cpu"))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert all(g.dtype == torch.float64 for g in got)
    for g, h in zip(got, td._mps_uniform_arrays(
            quimb_torch.MPS_rand_state(L, chi, seed=1, device="cpu"))):
        assert torch.equal(g, h)
    nrm = np.ones((1, 1))
    for A in to_numpy(got):
        nrm = np.einsum("ab,apx,bpy->xy", nrm, A, A)
    np.testing.assert_allclose(nrm.item(), 1.0, rtol=1e-12)


def test_mps_rand_state_matches_the_three_operand_normalisation():
    """The normalisation contracts its environment in two pairwise
    products; the arrays equal those of the former single three-operand
    ``np.einsum("ab,apx,bpy->xy", ...)`` at 1e-12 relative (L=8, chi=8)."""
    import math

    L, chi = 8, 8
    got = to_numpy(td._mps_uniform_arrays(
        quimb_torch.MPS_rand_state(L, chi, seed=3, device="cpu")))
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal((min(chi, 2**i, 2 ** (L - i)), 2,
                                   min(chi, 2 ** (i + 1), 2 ** (L - i - 1))))
              for i in range(L)]
    env, log_nrm2 = np.ones((1, 1)), 0.0
    for A in arrays:
        env = np.einsum("ab,apx,bpy->xy", env, A, A)
        scale = np.linalg.norm(env)
        env, log_nrm2 = env / scale, log_nrm2 + math.log(scale)
    f = math.exp(-(log_nrm2 + math.log(env.item())) / (2 * L))
    for g, A in zip(got, arrays):
        np.testing.assert_allclose(g, A * f, rtol=1e-12, atol=0)


def test_mps_rand_state_long_chain_float32():
    """128 sites of random tensors span hundreds of decades of norm; the
    log-space normalisation keeps every float32 tensor finite."""
    As = td._mps_uniform_arrays(quimb_torch.MPS_rand_state(
        128, 32, seed=42, dtype=torch.float32, device="cpu"))
    assert all(bool(torch.isfinite(A).all()) for A in As)
    nrm = np.ones((1, 1))
    for A in to_numpy(As):
        A = A.astype(np.float64)
        nrm = np.einsum("ab,apx,bpy->xy", nrm, A, A)
    np.testing.assert_allclose(nrm.item(), 1.0, rtol=1e-4)


def _random_bond(rng, cl=5, cr=6, d=2, w=4):
    return (rng.normal(size=(cl, w, cl)), rng.normal(size=(w, w, d, d)),
            rng.normal(size=(w, w, d, d)), rng.normal(size=(cr, w, cr)),
            rng.normal(size=(cl, d, d, cr)))


def test_env_steps_and_overlap_norm():
    rng = np.random.default_rng(10)
    L, W1, _, R, theta = _random_bond(rng)
    A = rng.normal(size=(5, 2, 7))   # (l, p, r) with l = L's bond
    B = rng.normal(size=(3, 2, 6))   # (l, p, r) with r = R's bond
    # float64 contractions of a few dozen terms: round-off level
    tol = dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        td._env_step_right(*_t(L, A, W1, A)).numpy(),
        np.asarray(jd._env_step_right(*map(jnp.asarray, (L, A, W1, A)))),
        **tol)
    np.testing.assert_allclose(
        td._env_step_left(*_t(R, B, W1, B)).numpy(),
        np.asarray(jd._env_step_left(*map(jnp.asarray, (R, B, W1, B)))),
        **tol)
    np.testing.assert_allclose(
        td._overlap_norm_2site(*_t(L, R, theta)).numpy(),
        np.asarray(jd._overlap_norm_2site(*map(jnp.asarray,
                                                (L, R, theta)))),
        **tol)


def test_right_canonize_step():
    rng = np.random.default_rng(11)
    A_next, A = rng.normal(size=(3, 2, 6)), rng.normal(size=(6, 2, 4))
    jn, ja = jd._right_canonize_step(jnp.asarray(A_next), jnp.asarray(A))
    tn, ta = td._right_canonize_step(*_t(A_next, A))
    # LQ with fixed signs: the factors agree to round-off
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-12)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-12)


def test_mpo_identity_channels():
    H = td._mpo_uniform_arrays(quimb_torch.MPO_ham_heis(6, device="cpu"))
    assert td._mpo_has_identity_channels(H)
    assert td._mpo_has_identity_channels(H) == \
        jd._mpo_has_identity_channels(
            jd._mpo_uniform_arrays(qtn.MPO_ham_heis(6)))
    rng = np.random.default_rng(12)
    Ws = [torch.from_numpy(rng.normal(size=W.shape)) for W in H]
    assert not td._mpo_has_identity_channels(Ws)


def test_split_methods_other_than_svd_raise():
    """Split methods other than "svd" and its three variants raise
    (quimb_tpu runs an unknown method as "svd"); the variants run."""
    theta = torch.ones((2, 2, 2, 2), dtype=torch.float64)
    for method in ("qr", "svd:rand", "eig"):
        with pytest.raises(ValueError):
            td._split_2site(theta, 2, 0.0, "right", method=method)
    for method in ("svd", "svd:eig", "svd:sub", "svd:sub0"):
        A1, A2, _ = td._split_2site(theta, 2, 0.0, "right", method=method)
        torch.testing.assert_close(torch.einsum("kpc,cqr->kpqr", A1, A2),
                                   theta)


def test_entry_local_update():
    """One DMRG2 local update (solve, split, absorb) on the inputs of
    quimb_tpu's ``__graft_entry__.entry()``, promoted to float64."""
    fn, args = entry()
    args64 = [np.asarray(a, dtype=np.float64) for a in args]
    j_en, j_A1, j_A2, j_newL = map(np.asarray,
                                   fn(*map(jnp.asarray, args64)))

    L, W1, W2, R, theta0 = _t(*args64)
    en, theta = td._local_solve_2site(L, W1, W2, R, theta0, ncv=8,
                                      restarts=2)
    A1, A2, _ = td._split_2site(theta, max_bond=theta0.shape[0],
                                cutoff=0.0, absorb="right")
    newL = td._env_step_right(L, torch.conj(A1), W1, A1).numpy()

    # two Lanczos passes in float64 on the same operator: round-off
    # level, a little amplified by the restart
    np.testing.assert_allclose(float(en), float(j_en), rtol=1e-10)
    # A1 and A2 carry a sign gauge per bond index, and the Ritz vector
    # an overall sign from each side's eigh; the product up to that sign
    # and the gauge-invariant contractions of newL carry none. The
    # truncation to 16 of 32 singular values adds the sensitivity of the
    # kept subspace.
    got = torch.einsum("kpc,cqr->kpqr", A1, A2).numpy()
    want = np.einsum("kpc,cqr->kpqr", j_A1, j_A2)
    got *= np.sign(np.vdot(got, want))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)
    for contract in (lambda x: np.einsum("awa->", x), np.linalg.norm):
        np.testing.assert_allclose(contract(newL), contract(j_newL),
                                   rtol=1e-8)


def _both_engines(L, chi, seed):
    H = qtn.MPO_ham_heis(L)
    p0 = qtn.MPS_rand_state(L, chi, seed=seed)
    jdmrg = qtn.DMRG2(H, bond_dims=chi, cutoffs=0.0, p0=p0)
    tdmrg = quimb_torch.DMRG2(from_tpu_mpo(H, device="cpu"), bond_dims=chi,
                              cutoffs=0.0,
                              p0=from_tpu_mps(p0, device="cpu"))
    return jdmrg, tdmrg


def test_sweeps_exact_regime():
    """L=10, chi=32 holds the exact ground state, so no sweep truncates:
    both engines do the same arithmetic from the same start state."""
    jdmrg, tdmrg = _both_engines(10, 32, seed=3)
    sweeps = [("R", True), ("L", False), ("R", False), ("L", False)]
    for direction, canonize in sweeps:
        kw = dict(max_bond=32, cutoff=0.0, canonize=canonize)
        j_en = jdmrg.sweep(direction, **kw)
        t_en = tdmrg.sweep(direction, **kw)
        # float64 Lanczos and SVD from one state; the SVD's sign gauge
        # does not reach the energies
        assert abs(t_en - j_en) < 1e-9
    assert abs(t_en - E_EXACT_L10) < 1e-8


def test_sweeps_fused_regime():
    """L=24, chi=8: quimb_tpu runs its fused lax.scan bulk sweep here,
    the port its per-site loop; the first right sweep agrees."""
    jdmrg, tdmrg = _both_engines(24, 8, seed=4)
    a, b = jdmrg._uniform_bulk_range()
    assert b - a >= 12   # quimb_tpu's condition for the fused path
    j_en = jdmrg.sweep("R", max_bond=8, cutoff=0.0)
    t_en = tdmrg.sweep("R", max_bond=8, cutoff=0.0)
    # truncating sweep in float64: round-off through 23 SVD splits
    assert abs(t_en - j_en) < 1e-8


def test_solve_matches():
    """``solve`` with a bond-dimension schedule and an R/L sequence,
    which re-canonizes only where the direction repeats."""
    jdmrg, tdmrg = _both_engines(10, 8, seed=5)
    kw = dict(tol=1e-9, bond_dims=[8, 16, 32], cutoffs=1e-12,
              sweep_sequence="RRL", max_sweeps=6)
    assert jdmrg.solve(**kw) == tdmrg.solve(**kw)
    np.testing.assert_allclose(tdmrg.energies, jdmrg.energies, atol=1e-9)
    assert abs(tdmrg.energy - E_EXACT_L10) < 1e-8
    assert [tuple(A.shape) for A in td._mps_uniform_arrays(tdmrg.state)] \
        == [jdmrg._A[i].shape for i in range(10)]


def test_default_start_state():
    H = quimb_torch.MPO_ham_heis(8, dtype=torch.float32, device="cpu")
    dmrg = quimb_torch.DMRG2(H, bond_dims=4)
    assert all(t.dtype == torch.float32 for t in dmrg.state)
    assert dmrg.energy is None
    en = dmrg.sweep("R", max_bond=4, cutoff=0.0)
    assert np.isfinite(en)


def test_default_split_by_device():
    """quimb_tpu's defaults: its accelerator split on a GPU, its CPU split
    on the CPU (no tensor is made)."""
    from quimb_torch.tensor.tn1d.dmrg import get_default_opts

    assert get_default_opts(torch.device("cuda"))["bond_compress_method"] \
        == "svd:sub"
    assert get_default_opts("cuda:0")["bond_compress_method"] == "svd:sub"
    assert get_default_opts(torch.device("cpu"))["bond_compress_method"] \
        == "svd"
    H = quimb_torch.MPO_ham_heis(6, device="cpu")
    for engine in (quimb_torch.DMRG2, quimb_torch.DMRG1):
        dmrg = engine(H, bond_dims=4)
        assert dmrg.opts["bond_compress_method"] == "svd"
        assert dmrg._split_method(0.0) == "svd"
        dmrg.opts["bond_compress_method"] = "svd:sub"
        assert dmrg._split_method(0.0) == "svd:sub0"
        assert dmrg._split_method(1e-10) == "svd:sub"
