"""quimb_torch's TEBD, its builders and its batched bond update, against
quimb_tpu's, on the CPU. Complex128 (float64 for imaginary time) unless a
test says otherwise; states from quimb_tpu cross as numpy arrays.

SVD factors carry a phase per singular vector that differs between LAPACK
under JAX and under torch, so the tests compare gauge-free quantities:
products of split factors, Schmidt weights, entropies, energies, and
dense states of small chains with their fidelities."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import quimb_tpu.tensor as qtn
import quimb_torch
from quimb_torch.convert import from_tpu_mps
from quimb_tpu.tensor.tn1d import tebd as jt
from quimb_torch.tensor.tn1d import core as tc
from quimb_torch.tensor.tn1d import tebd as tt

CPU = "cpu"


def _arrays(x):
    """The uniform site arrays of the port's MPS or MPO, or a list of
    tensors as it is."""
    if isinstance(x, tc.MatrixProductState):
        return tc._mps_uniform_arrays(x)
    if isinstance(x, tc.MatrixProductOperator):
        return tc._mpo_uniform_arrays(x)
    return x


def _dense(psi):
    """The state vector of an MPS or a list state (l, p, r)."""
    As = _arrays(psi)
    v = torch.ones((1, 1), dtype=As[0].dtype)
    for A in As:
        v = torch.einsum("ab,bpc->apc", v, A).reshape(-1, A.shape[2])
    return v.reshape(-1).numpy()


def _fidelity(a, b):
    return abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))


def _dense_ham(H):
    """The dense Hamiltonian of a LocalHam1D's open-chain terms."""
    L = H.L
    d = int(round(H.terms[(0, 1)].shape[0] ** 0.5))
    out = np.zeros((d**L, d**L), dtype=complex)
    for (i, _), h in H.terms.items():
        out += np.kron(np.kron(np.eye(d**i), h), np.eye(d ** (L - i - 2)))
    return out


def _host_energy(psi, H):
    """⟨ψ|H|ψ⟩ / ⟨ψ|ψ⟩ of an MPS under an MPO, by their uniform arrays
    (l, p, r) and (wl, wr, u, d), in complex128 numpy (``host_f64_energy``
    of chip_smoke.py, for complex states)."""
    env = np.ones((1, 1, 1))
    nrm = np.ones((1, 1))
    for A, W in zip(_arrays(psi), _arrays(H)):
        A = A.numpy().astype(np.complex128)
        W = W.numpy()
        env = np.einsum("bwk,kdx->bwdx", env, A)
        env = np.einsum("bwdx,wyud->byux", env, W)
        env = np.einsum("byux,bua->ayx", env, A.conj())
        nrm = np.einsum("bk,kdx,bda->ax", nrm, A, A.conj())
    return (env.reshape(()) / nrm.reshape(())).real


# -- builders -----------------------------------------------------------------


HAMS = [
    ("ham_1d_heis", dict()),
    ("ham_1d_heis", dict(j=(1.0, 0.7, 0.3), bz=0.4)),
    ("ham_1d_ising", dict()),
    ("ham_1d_ising", dict(j=1.5, bx=0.0)),
    ("ham_1d_XY", dict(j=(0.8, 1.2), bz=0.2)),
    ("ham_1d_XXZ", dict(delta=0.5)),
    ("ham_1d_bilinear_biquadratic", dict(theta=0.3)),
    ("ham_1d_heis", dict(S=1)),
]


@pytest.mark.parametrize("name,kw", HAMS)
def test_local_ham_terms_match(name, kw):
    L = 6
    want = getattr(qtn, name)(L, **kw)
    got = getattr(quimb_torch, name)(L, **kw)
    assert sorted(got.terms) == sorted(want.terms)
    # the same sums of Kronecker products in numpy: round-off level
    for key, h in want.terms.items():
        np.testing.assert_allclose(got.terms[key], np.asarray(h), rtol=0,
                                   atol=1e-14)
    assert got.mean_norm() == pytest.approx(want.mean_norm(), rel=1e-14)
    np.testing.assert_allclose(got.get_term((3, 2)),
                               np.asarray(want.get_term((3, 2))), atol=1e-14)
    # a 4 x 4 (9 x 9 for S=1) eigh and two products in complex128
    np.testing.assert_allclose(
        got.get_gate_expm((1, 2), -0.1j, device=CPU).numpy(),
        np.asarray(want.get_gate_expm((1, 2), -0.1j)), rtol=0, atol=1e-13)


@pytest.mark.parametrize("build", [
    lambda m, **kw: m.MPS_computational_state("011010", **kw),
    lambda m, **kw: m.MPS_computational_state([1, 1, 0, 1, 0], **kw),
    lambda m, **kw: m.MPS_neel_state(7, **kw),
    lambda m, **kw: m.MPS_neel_state(6, down_first=True, **kw),
])
def test_product_states_match(build):
    want = np.asarray(build(qtn).to_dense()).ravel()
    got = build(quimb_torch, device=CPU)
    assert isinstance(got, tc.MatrixProductState)
    assert all(A.shape[0] == A.shape[2] == 1 for A in _arrays(got))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(_dense(got), want)


def test_cyclic_chain_is_not_ported():
    """Once left out naming ROADMAP item 14(c), the ring is now ported
    (the name is kept): a ring Hamiltonian's TEBD runs on a cyclic MPS and
    gates the wrap bond; DMRG2 of a ring MPO builds the segmented engine
    when asked, and the open form otherwise."""
    H = quimb_torch.ham_1d_heis(6, cyclic=True)
    assert (5, 0) in H.terms
    with pytest.raises(ValueError, match="cyclic MPS"):
        quimb_torch.TEBD(quimb_torch.MPS_neel_state(6, device=CPU), H)
    tebd = quimb_torch.TEBD(
        quimb_torch.MPS_neel_state(6, cyclic=True, device=CPU), H,
        split_opts={"max_bond": 8})
    assert not tebd._fused_applicable()
    tebd.update_to(0.1, dt=0.05)
    assert tebd.pt.cyclic
    # the wrap bond was gated: it carries more than the product state's 1
    psi = tebd.pt
    assert psi.bond_size(5, 0) > 1
    H = quimb_torch.MPO_ham_heis(6, cyclic=True, device=CPU)
    assert H.cyclic
    assert quimb_torch.DMRG2(H, cyclic_mode="segmented")._cyc is not None
    assert not quimb_torch.DMRG2(H, cyclic_mode="obc").ham.cyclic


@pytest.mark.parametrize("build", [
    lambda: quimb_torch.MPS_rand_state(8, 4),
    lambda: quimb_torch.MPO_ham_heis(8),
    lambda: quimb_torch.MPS_computational_state("01" * 4),
    lambda: quimb_torch.MPS_neel_state(8),
    lambda: from_tpu_mps(qtn.MPS_computational_state("01")),
    lambda: [quimb_torch.ham_1d_heis(4).get_gate_expm((0, 1), -0.1j)],
])
def test_entry_points_default_to_the_gpu(build):
    """With no ``device``, the tensors go to the GPU; with no GPU the call
    raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        out = build()
        leaves = [t.data for t in out] if hasattr(out, "tensor_map") \
            else out
        assert all(t.is_cuda for t in leaves)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


# -- the kernels of the fused path --------------------------------------------


@pytest.mark.parametrize("factor", [-0.3j, -0.2, 0.7j])
def test_expm_herm(factor):
    rng = np.random.default_rng(40)
    X = rng.normal(size=(3, 4, 4)) + 1j * rng.normal(size=(3, 4, 4))
    Hs = X + X.conj().transpose(0, 2, 1)
    got = tt._expm_herm(torch.from_numpy(Hs), factor).numpy()
    for H, g in zip(Hs, got):
        want = np.asarray(jt._expm_herm(jnp.asarray(H), factor))
        # a 4 x 4 eigh and two products in complex128
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-13)
        np.testing.assert_allclose(g, sla.expm(factor * H), rtol=0,
                                   atol=1e-13)


def _bond_batch(truncating, m=3, chi=8, d=2, seed=41):
    """Random complex B-form pairs, weights and two-site unitaries. Without
    truncation the outer bonds span 4 of chi, so theta has rank <= 8 =
    chi and nothing is dropped."""
    rng = np.random.default_rng(seed)

    def c(*shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    B1, B2, ll = c(m, chi, d, chi), c(m, chi, d, chi), rng.random((m, chi))
    if not truncating:
        B1[:, 4:], B2[:, :, :, 4:], ll[:, 4:] = 0, 0, 0
    X = c(m, d * d, d * d)
    Us = np.stack([sla.expm(-0.3j * (x + x.conj().T)) for x in X])
    return B1, B2, ll / np.linalg.norm(ll, axis=1, keepdims=True), Us


@pytest.mark.parametrize("truncating", [True, False])
def test_bform_gate_split_batch(truncating):
    B1, B2, ll, Us = _bond_batch(truncating)
    kw = dict(max_bond=8, cutoff=1e-10)
    jB1, jB2, js, jerr = (np.asarray(x) for x in jt._bform_gate_split_batch(
        *map(jnp.asarray, (B1, B2, ll, Us)), **kw))
    tB1, tB2, ts, terr = (x.numpy() for x in tt._bform_gate_split_batch(
        *map(torch.from_numpy, (B1, B2, ll, Us)), **kw))
    # an SVD of 16 x 16 complex128 matrices with a spectral gap at the cut
    tol = dict(rtol=0, atol=1e-12)
    np.testing.assert_allclose(ts, js, **tol)
    np.testing.assert_allclose(terr, jerr, **tol)
    assert (terr > 0).all() == truncating
    np.testing.assert_allclose(np.einsum("mlpc,mcqr->mlpqr", tB1, tB2),
                               np.einsum("mlpc,mcqr->mlpqr", jB1, jB2), **tol)
    # B2' is right-canonical on the kept bond, zero on the masked rows
    gram = np.einsum("mapr,mbpr->mab", tB2, tB2.conj())
    kept = (ts > 0).astype(float)
    np.testing.assert_allclose(gram, kept[:, :, None] * np.eye(8), **tol)


def test_mps_to_vidal():
    L, chi = 8, 6
    psi = qtn.MPS_rand_state(L, 4, seed=42)
    jBs, jls = (np.asarray(x) for x in jt._mps_to_vidal(psi, chi))
    Bs, ls = tt._mps_to_vidal(_arrays(
        from_tpu_mps(psi, device=CPU, dtype=torch.complex128)), chi)
    assert Bs.dtype == torch.complex128 and ls.dtype == torch.float64
    # one LQ sweep and one SVD sweep of bond 4 in float64
    np.testing.assert_allclose(ls.numpy(), jls, rtol=0, atol=1e-12)
    want = np.asarray(psi.to_dense()).ravel()
    want = want / np.linalg.norm(want)
    for stack in (Bs.numpy(), jBs):
        v = np.ones((1, 1))
        for B in stack:
            v = np.einsum("ab,bpc->apc", v, B).reshape(-1, chi)
        np.testing.assert_allclose(v[:, 0], want, rtol=0, atol=1e-12)


def test_vidal_bonds_in_the_basis_of_their_weights():
    """The port's B-form holds each bond in the basis of its weights: the
    left environment of every bond is diag(ls^2). (quimb_tpu's keeps the
    right-canonical tensors as they are: correct only for product
    states.)"""
    psi = _arrays(from_tpu_mps(qtn.MPS_rand_state(8, 4, seed=43),
                               device=CPU))
    Bs, ls = tt._mps_to_vidal(psi, 6)
    env = torch.zeros((6, 6), dtype=Bs.dtype)
    env[0, 0] = 1
    for i in range(8):
        env = torch.einsum("ab,apx,bpy->xy", env, Bs[i], torch.conj(Bs[i]))
        np.testing.assert_allclose(env.numpy(), np.diag(ls[i + 1] ** 2),
                                   rtol=0, atol=1e-12)


# -- TEBD ---------------------------------------------------------------------


def _pair(L, dtype, split_opts, imag=False, fused=True, start=None):
    """quimb_tpu's TEBD and the port's, from the same state."""
    jdtype, tdtype = {"float64": ("float64", torch.float64),
                      "float32": ("float32", torch.float32)}[dtype]
    jpsi = start or qtn.MPS_neel_state(L, dtype=jdtype)
    tpsi = from_tpu_mps(jpsi, device=CPU, dtype=tdtype)
    j = qtn.TEBD(jpsi, qtn.ham_1d_heis(L), imag=imag, progbar=False,
                 split_opts=dict(split_opts), fused=fused)
    t = quimb_torch.TEBD(tpsi, quimb_torch.ham_1d_heis(L), imag=imag,
                         split_opts=dict(split_opts), fused=fused)
    return j, t, jpsi


@pytest.mark.parametrize("order", [2, 4])
def test_fused_quench_matches(order):
    L, dt, steps = 10, 0.05, 12
    j, t, psi0 = _pair(L, "float64", {"max_bond": 16, "cutoff": 1e-10})
    ej, et = [], []
    for k in range(1, steps + 1):
        j.update_to(k * dt, dt=dt, order=order, progbar=False)
        t.update_to(k * dt, dt=dt, order=order)
        ej.append(j.entropy(L // 2))
        et.append(t.entropy(L // 2))
    # complex128 on both: the entropies follow each other to round-off
    # accumulated over 12 * 15 batched SVDs
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-9)
    assert t.err == pytest.approx(j.err, rel=1e-12)
    assert t.trunc_err > 0
    assert t.trunc_err == pytest.approx(j.trunc_err, rel=0, abs=1e-9)
    assert t._vidal[0].dtype == torch.complex128
    v = _dense(t.pt)
    assert _fidelity(v, np.asarray(j.pt.to_dense()).ravel()) > 1 - 1e-10
    v0 = np.asarray(psi0.to_dense()).ravel()
    exact = sla.expm(-1j * steps * dt * _dense_ham(t.H)) @ v0
    # the bound of quimb_tpu's own test (tests/test_tensor/test_tn1d.py:
    # 380); at t = 0.6 the truncation to 16, not the Trotter error, leaves
    # about 3e-8 at both orders
    assert _fidelity(v, exact) > 1 - 1e-7


def test_fused_quench_complex64_matches():
    """The port's complex64 quench against quimb_tpu's complex128 one.
    (quimb_tpu's own complex64 run drops, at every split, the weight below
    float32's resolution of the total, whatever the cutoff; the port's
    truncation mask keeps the weight above the cutoff.)"""
    L, dt, steps = 10, 0.05, 12
    opts = {"max_bond": 16, "cutoff": 1e-10}
    j, _, _ = _pair(L, "float64", opts)
    _, t, _ = _pair(L, "float32", opts)
    ej, et = [], []
    for k in range(1, steps + 1):
        j.update_to(k * dt, dt=dt, progbar=False)
        t.update_to(k * dt, dt=dt)
        ej.append(j.entropy(L // 2))
        et.append(t.entropy(L // 2))
    assert t._vidal[0].dtype == torch.complex64
    assert t._vidal[1].dtype == torch.float32
    # complex64 against complex128: float32 round-off of 180 batched
    # splits (1.1e-6 on a CPU)
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-5)


def test_fused_from_a_random_state_keeps_true_entropies():
    """From an entangled start, the fused weights give the entropies of
    the state they describe (quimb_tpu's differ at the far bonds for the
    first L / 2 sweeps) and the state follows the sequential path."""
    L = 10
    start = qtn.MPS_rand_state(L, 4, seed=44)
    _, t, _ = _pair(L, "float64", {"max_bond": 16, "cutoff": 1e-12},
                    start=start)
    _, s, _ = _pair(L, "float64", {"cutoff": 1e-12}, start=start)
    for tebd in (t, s):
        tebd.update_to(0.1, dt=0.05, order=2)
    fused = [t.entropy(i) for i in range(1, L)]
    np.testing.assert_allclose(fused, [s.entropy(i) for i in range(1, L)],
                               rtol=0, atol=1e-9)
    t.pt
    np.testing.assert_allclose(fused, [t.entropy(i) for i in range(1, L)],
                               rtol=0, atol=1e-9)
    # the two paths drop values below the cutoff of 1e-12 in different
    # gauges (the sequential one in an uncanonised theta)
    assert _fidelity(_dense(t.pt), _dense(s.pt)) > 1 - 1e-10


def test_sequential_path_matches():
    L, T = 8, 1.0
    j, t, psi0 = _pair(L, "float64", {"cutoff": 1e-10})
    assert not t._fused_applicable()
    j.update_to(T, dt=0.05, progbar=False)
    t.update_to(T, dt=0.05)
    assert t._vidal is None
    v = _dense(t.pt)
    assert _fidelity(v, np.asarray(j.pt.to_dense()).ravel()) > 1 - 1e-10
    # the split errors added into err are norms of dropped singular values
    assert t.err == pytest.approx(j.err, rel=1e-6)
    v0 = np.asarray(psi0.to_dense()).ravel()
    exact = sla.expm(-1j * T * _dense_ham(t.H)) @ v0
    assert _fidelity(v, exact) > 1 - 1e-4
    # the list state's Schmidt values, from a canonising SVD sweep, are
    # those of its dense vector
    s = np.linalg.svd(v.reshape(2**4, 2**4), compute_uv=False)
    s = s[s > 1e-14]
    np.testing.assert_allclose(t.schmidt_values(4), s**2 / np.sum(s**2),
                               rtol=0, atol=1e-12)


def test_fused_and_sequential_agree():
    L, T = 8, 0.5
    _, f, _ = _pair(L, "float64", {"max_bond": 32, "cutoff": 1e-12})
    _, s, _ = _pair(L, "float64", {"max_bond": 32, "cutoff": 1e-12},
                    fused=False)
    for tebd in (f, s):
        tebd.update_to(T, dt=0.02)
    assert f._vidal is not None and s._vidal is None
    # the bound of quimb_tpu's own test of the two paths
    # (tests/test_tensor/test_tn1d.py:381): they truncate at the cutoff
    # in different gauges
    assert _fidelity(_dense(f.pt), _dense(s.pt)) > 1 - 1e-7


def test_imaginary_time_energy_matches():
    L = 10
    j, t, _ = _pair(L, "float64", {"max_bond": 16, "cutoff": 1e-10},
                    imag=True)
    j.update_to(1.0, dt=0.05, progbar=False)
    t.update_to(1.0, dt=0.05)
    assert t._vidal[0].dtype == torch.float64
    Ws = quimb_torch.MPO_ham_heis(L, device=CPU)
    e_t = _host_energy(t.pt, Ws)
    e_j = _host_energy(from_tpu_mps(j.pt, device=CPU), Ws)
    # two float64 runs of 20 steps: round-off in the energy
    assert e_t == pytest.approx(e_j, rel=0, abs=1e-9)
    assert e_t < -3.5


def test_update_to_remainder_and_at_times():
    L = 8
    opts = {"max_bond": 16, "cutoff": 1e-10}
    j, t, _ = _pair(L, "float64", opts)
    # 0.37 is no multiple of 0.05: the last step is scaled to end on it
    j.update_to(0.37, dt=0.05, progbar=False)
    t.update_to(0.37, dt=0.05)
    assert t.t == pytest.approx(0.37, abs=1e-13)
    assert t.taus == pytest.approx(j.taus, rel=1e-14)
    assert t.err == pytest.approx(j.err, rel=1e-12)
    assert t._U_cache == {}
    assert t.entropy() == pytest.approx(j.entropy(), abs=1e-10)
    ts = [0.45, 0.6]
    for jp, tp in zip(j.at_times(ts, dt=0.05), t.at_times(ts, dt=0.05)):
        assert _fidelity(_dense(tp), np.asarray(jp.to_dense()).ravel()) \
            > 1 - 1e-12
    assert t.t == pytest.approx(0.6, abs=1e-13)


def test_tol_chooses_the_time_step():
    L = 8
    j, t, _ = _pair(L, "float64", {"max_bond": 16})
    j.tol = t.tol = 1e-3
    j.update_to(0.4, progbar=False)
    t.update_to(0.4)
    assert t.dt == pytest.approx(j.dt, rel=1e-14)
    assert t.err == pytest.approx(j.err, rel=1e-12) and t.err < 1e-3


@pytest.fixture
def one_thread():
    """One torch thread for a test of hundreds of small steps, which
    threads only slow down beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("imag", [False, True])
def test_ring_evolution_matches(imag, one_thread):
    """TEBD on a 6-site ring, from the cyclic Néel state, two order-4
    steps of 0.05 bond by bond on the cyclic MPS (the wrap bond in the odd
    sweeps): real time in complex128, imaginary time in float64. Every
    bond entropy and ``err`` (Trotter estimate plus the split errors)
    match quimb_tpu's to 1e-10: the same sequence of reduce-split moves
    and float64 / complex128 SVDs, round-off apart."""
    L = 6
    dtype = "float64" if imag else "complex128"
    kw = dict(split_opts={"max_bond": 8, "cutoff": 1e-10}, imag=imag)
    jt_ = qtn.TEBD(qtn.MPS_neel_state(L, cyclic=True, dtype=dtype),
                   qtn.ham_1d_heis(L, cyclic=True), progbar=False, **kw)
    jt_.update_to(0.1, dt=0.05, order=4)
    tt_ = quimb_torch.TEBD(
        quimb_torch.MPS_neel_state(L, cyclic=True, dtype=getattr(
            torch, dtype), device=CPU),
        quimb_torch.ham_1d_heis(L, cyclic=True), **kw)
    tt_.update_to(0.1, dt=0.05, order=4)
    assert tt_.pt.cyclic and tt_.pt.dtype == getattr(torch, dtype)
    np.testing.assert_allclose([tt_.entropy(i) for i in range(1, L)],
                               [jt_.entropy(i) for i in range(1, L)],
                               atol=1e-10)
    assert abs(tt_.err - jt_.err) <= 1e-10 * max(abs(jt_.err), 1e-12)
