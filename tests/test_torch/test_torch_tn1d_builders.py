"""quimb_torch's MPS / MPO builders, and the engines that take them (DMRG,
DMRGX, ParallelDMRG, MovingEnvironment, TEBD, the Trotterized
propagator and OTOC_local), against quimb_tpu's, in float64 /
complex128 on the CPU.

quimb_tpu's random builders draw from JAX's generator, the port's from
``np.random.default_rng``: random states cross with
``convert.from_tpu_mps``, and the port's own draws are checked for the
properties they promise (norm, shapes, seeding). The deterministic
builders are compared as dense vectors and operators, to 1e-14 (the
same sums of Kronecker products in float64).
"""

import functools

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import quimb_tpu as q
import quimb_tpu.tensor as qtn
from quimb_tpu.tensor.tn1d import tebd as jtebd
import quimb_torch
from quimb_torch.convert import from_tpu_mpo, from_tpu_mps
from quimb_torch.tensor.tn1d import core as tc
from quimb_torch.tensor.tn1d import dmrg as td

CPU = "cpu"


def _n(x):
    x = getattr(x, "data", x)
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().numpy()
    return np.asarray(x)


def _dense(x):
    return _n(x.to_dense())


def _exact_e(L, cyclic=False):
    return spla.eigsh(q.ham_heis(L, sparse=True, cyclic=cyclic), k=1,
                      which="SA")[0][0]


# -- MPS builders ---------------------------------------------------------------


@pytest.mark.parametrize("build", [
    lambda m, **kw: m.MPS_computational_state("0110", **kw),
    lambda m, **kw: m.MPS_product_state(
        [np.array([0.6, 0.8]), np.array([1.0, 0.0]), np.array([0.0, 1.0])],
        **kw),
    lambda m, **kw: m.MPS_neel_state(5, down_first=True, **kw),
    lambda m, **kw: m.MPS_rand_computational_state(6, seed=4, **kw),
    lambda m, **kw: m.MPS_sampler(5, seed=9, **kw),
    lambda m, **kw: m.MPS_ghz_state(5, **kw),
    lambda m, **kw: m.MPS_w_state(5, **kw),
    lambda m, **kw: m.MPS_COPY(4, **kw),
    lambda m, **kw: m.MPS_zero_state(4, bond_dim=2, **kw),
], ids=["computational", "product", "neel", "rand_computational",
        "sampler", "ghz", "w", "COPY", "zero"])
def test_mps_builders_match(build):
    got = build(quimb_torch, device=CPU)
    want = build(qtn)
    assert isinstance(got, tc.MatrixProductState)
    assert got.site_inds == want.site_inds
    assert got.site_tags == want.site_tags
    assert got.bond_sizes() == want.bond_sizes()
    np.testing.assert_allclose(_dense(got), _dense(want), rtol=0,
                               atol=1e-14)


@pytest.mark.parametrize("cyclic", [False, True])
def test_mps_rand_state(cyclic):
    """The port's own draw: quimb_tpu's shapes, unit norm, one seed one
    state; ``dtype`` and ``site_ind_id`` as asked."""
    psi = quimb_torch.MPS_rand_state(7, 4, seed=3, cyclic=cyclic,
                                     device=CPU)
    want = qtn.MPS_rand_state(7, 4, seed=3, cyclic=cyclic)
    assert psi.cyclic == cyclic == want.cyclic
    assert [t.shape for t in psi] == [tuple(t.shape) for t in want]
    assert abs(complex(tc.expec_TN_1D(psi.H, psi)) - 1) < 1e-12
    again = quimb_torch.MPS_rand_state(7, 4, seed=3, cyclic=cyclic,
                                       device=CPU)
    assert all(torch.equal(a.data, b.data) for a, b in zip(psi, again))
    f32 = quimb_torch.MPS_rand_state(7, 4, seed=3, dtype=torch.float32,
                                     site_ind_id="s{}", device=CPU)
    assert f32.dtype == torch.float32 and f32.site_ind(2) == "s2"


# -- MPO builders ---------------------------------------------------------------


@pytest.mark.parametrize("build", [
    lambda m, **kw: m.MPO_ham_heis(5, **kw),
    lambda m, **kw: m.MPO_ham_heis(5, j=(1.0, 0.5, 0.3), bz=0.2, **kw),
    lambda m, **kw: m.MPO_ham_heis(5, cyclic=True, **kw),
    lambda m, **kw: m.MPO_ham_heis(4, S=1, **kw),
    lambda m, **kw: m.MPO_ham_XY(5, j=(0.8, 1.2), bz=0.2, **kw),
    lambda m, **kw: m.MPO_ham_ising(5, j=1.5, bx=0.7, **kw),
    lambda m, **kw: m.MPO_ham_ising(5, cyclic=True, **kw),
    lambda m, **kw: m.MPO_ham_XXZ(5, delta=0.5, **kw),
    lambda m, **kw: m.MPO_ham_bilinear_biquadratic(4, theta=0.3, **kw),
    lambda m, **kw: m.MPO_identity(4, **kw),
    lambda m, **kw: m.MPO_identity(4, cyclic=True, **kw),
    lambda m, **kw: m.MPO_zeros(3, **kw),
    lambda m, **kw: m.MPO_product_operator(
        [np.diag([1.0, -1.0]), np.array([[0.0, 1.0], [1.0, 0.0]]),
         np.eye(2)], **kw),
], ids=["heis", "heis_aniso", "heis_cyclic", "heis_S1", "XY", "ising",
        "ising_cyclic", "XXZ", "bilinear_biquadratic", "identity",
        "identity_cyclic", "zeros", "product_operator"])
def test_mpo_builders_match(build):
    got = build(quimb_torch, device=CPU)
    want = build(qtn)
    assert isinstance(got, tc.MatrixProductOperator)
    assert got.cyclic == want.cyclic
    assert (got.upper_inds, got.lower_inds) == (want.upper_inds,
                                                want.lower_inds)
    if not got.cyclic:
        assert got.bond_sizes() == want.bond_sizes()
    np.testing.assert_allclose(_dense(got), _dense(want), rtol=0,
                               atol=1e-13)


def test_mpo_like_builders_and_rand():
    H = quimb_torch.MPO_ham_heis(4, device=CPU)
    ident = quimb_torch.MPO_identity_like(H)
    zeros = quimb_torch.MPO_zeros_like(H)
    assert ident.upper_ind_id == H.upper_ind_id
    assert np.allclose(_dense(ident), np.eye(16))
    assert not _dense(zeros).any()
    r = quimb_torch.MPO_rand(4, 3, seed=2, device=CPU)
    assert abs(complex((r.H.copy() & r.copy()).contract(...))) == \
        pytest.approx(1.0, abs=1e-12)
    h = quimb_torch.MPO_rand_herm(4, 3, seed=2, dtype=torch.complex128,
                                  device=CPU)
    A = _dense(h)
    assert np.allclose(A, A.conj().T, atol=1e-14)


def test_spin_ham_per_site_terms():
    """Per-site terms, as ``H[i] = ...`` and ``H[i, i + 1] += ...``, on an
    open and a cyclic chain, and the LocalHam1D of the same terms."""
    def build(m, cyclic):
        H = m.SpinHam1D(S=1 / 2, cyclic=cyclic)
        H += 1.0, "Z", "Z"
        H += 0.5, "X"
        H[2] = [(0.3, "Z")]
        H[1, 2] += 0.7, "X", "X"
        return H

    for cyclic in (False, True):
        got = build(quimb_torch, cyclic).build_mpo(5, device=CPU)
        want = build(qtn, cyclic).build_mpo(5)
        np.testing.assert_allclose(_dense(got), _dense(want), rtol=0,
                                   atol=1e-13)
    lh = build(quimb_torch, False).build_local_ham(5)
    lj = build(qtn, False).build_local_ham(5)
    for key, h in lj.terms.items():
        np.testing.assert_allclose(lh.terms[key], np.asarray(h), atol=1e-14)


# -- DMRG from objects --------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _tpu_dmrg(bsz, L=12, chi=8, seed=7):
    """quimb_tpu's DMRG of the L=12 chain at chi=8 from a random state:
    (H, p0, its energies)."""
    H = qtn.MPO_ham_heis(L)
    p0 = qtn.MPS_rand_state(L, chi, seed=seed)
    cls = {1: qtn.DMRG1, 2: qtn.DMRG2}[bsz]
    d = cls(H, bond_dims=chi, cutoffs=1e-10, p0=p0)
    if bsz == 1:
        d.opts["local_eig_ncv"], d.opts["local_eig_ncv_floor"] = 2, 4
    d.solve(tol=1e-10, max_sweeps=4, sweep_sequence="RL")
    return H, p0, tuple(d.energies)


@pytest.mark.parametrize("bsz", [2, 1])
def test_dmrg_from_objects(bsz):
    """DMRG2 and DMRG1 from quimb_tpu's MPO and start state, carried
    across: the sweep energies of test_torch_dmrg.py's tolerance, and
    ``.state`` an MPS with the start state's ids whose energy is the
    last one."""
    H, p0, want = _tpu_dmrg(bsz)
    cls = {1: quimb_torch.DMRG1, 2: quimb_torch.DMRG2}[bsz]
    d = cls(from_tpu_mpo(H, device=CPU), bond_dims=8, cutoffs=1e-10,
            p0=from_tpu_mps(p0, device=CPU))
    if bsz == 1:
        d.opts["local_eig_ncv"], d.opts["local_eig_ncv_floor"] = 2, 4
    d.solve(tol=1e-10, max_sweeps=4, sweep_sequence="RL")
    np.testing.assert_allclose(d.energies, want, atol=1e-9)
    psi = d.state
    assert isinstance(psi, tc.MatrixProductState)
    assert psi.site_inds == p0.site_inds and psi.site_tags == p0.site_tags
    tH = from_tpu_mpo(H, device=CPU)
    e = complex(tc.expec_TN_1D(*tc.align_TN_1D(psi.H, tH, psi)))
    n = complex(tc.expec_TN_1D(psi.H, psi))
    assert (e / n).real == pytest.approx(d.energy, abs=1e-9)


def test_dmrg_cyclic_and_default_start():
    """A ring Hamiltonian runs in its open form (``to_obc``) and reaches
    the ring's ground energy; the ring engine raises naming item 14(c).
    With no start state the engine draws one with the MPO's ids."""
    H = quimb_torch.MPO_ham_heis(6, cyclic=True, device=CPU)
    d = quimb_torch.DMRG2(H, bond_dims=[8, 16], cutoffs=1e-12)
    assert not d.ham.cyclic
    d.solve(tol=1e-10, max_sweeps=8)
    assert d.energy == pytest.approx(_exact_e(6, cyclic=True), abs=1e-8)
    assert d.state.site_ind_id == H.upper_ind_id
    with pytest.raises(NotImplementedError, match=r"item 14\(c\)"):
        quimb_torch.DMRG2(quimb_torch.MPO_ham_heis(40, cyclic=True,
                                                   device=CPU))


def test_dmrgx_matches():
    """DMRG-X (dense local solves, the eigenvector of largest overlap)
    from a product state, against quimb_tpu's."""
    L = 5
    H = qtn.MPO_ham_heis(L, j=(1.0, 1.0, 1.3))
    p0 = qtn.MPS_neel_state(L)
    jd_ = qtn.DMRGX(H, p0, bond_dims=8)
    d = quimb_torch.DMRGX(from_tpu_mpo(H, device=CPU),
                          from_tpu_mps(p0, device=CPU), bond_dims=8)
    for direction in "RL":
        j_en = jd_.sweep(direction, max_bond=8, cutoff=1e-10)
        t_en = d.sweep(direction, max_bond=8, cutoff=1e-10)
        # dense float64 eighs of the same local operators
        assert t_en == pytest.approx(j_en, abs=1e-9)
    Heff = d.form_local_ops(2)
    assert np.allclose(_n(Heff), _n(Heff).T, atol=1e-12)


def test_parallel_dmrg_from_objects():
    """ParallelDMRG takes an MPS and an MPO and gives an MPS back."""
    H = quimb_torch.MPO_ham_heis(8, device=CPU)
    d = quimb_torch.DMRG2(H, bond_dims=8, cutoffs=1e-10,
                          p0=quimb_torch.MPS_rand_state(8, 4, seed=1,
                                                        device=CPU))
    d.solve(tol=1e-10, max_sweeps=6)
    pd = quimb_torch.ParallelDMRG(d.state, H, max_bond=8, n_segments=2)
    for _ in range(3):
        en = pd.sweep()
    assert en == pytest.approx(d.energy, abs=1e-6)
    psi = pd.get_state()
    assert isinstance(psi, tc.MatrixProductState)
    assert psi.site_tags == d.state.site_tags


def test_moving_environment():
    """The environments of a two-site block moved along the norm network
    of an MPS: every position's network contracts to <psi|psi>, as
    quimb_tpu's does."""
    j = qtn.MPS_rand_state(6, 4, seed=12)
    t = from_tpu_mps(j, device=CPU)
    want = complex(j.H @ j)
    for begin in ("left", "right"):
        jme = qtn.MovingEnvironment(j.make_norm(), begin=begin, bsz=2)
        me = td.MovingEnvironment(t.make_norm(), begin=begin, bsz=2)
        order = range(5) if begin == "left" else range(4, -1, -1)
        for i in order:
            me.move_to(i)
            jme.move_to(i)
            assert me.pos == jme.pos == i
            got = complex(me().contract(...))
            assert got == pytest.approx(want, rel=1e-12)
            assert complex(jme().contract(...)) == pytest.approx(want,
                                                                 rel=1e-12)
    assert me.init_segment("left", 0, 6).pos == 0
    assert me.init_non_segment(0, 6) is me


# -- TEBD, the propagator and OTOC_local ----------------------------------------------


def test_tebd_takes_and_gives_mps():
    psi0 = quimb_torch.MPS_neel_state(6, device=CPU)
    tebd = quimb_torch.TEBD(psi0, quimb_torch.ham_1d_heis(6),
                            split_opts={"max_bond": 8})
    tebd.update_to(0.2, dt=0.05)
    pt = tebd.pt
    assert isinstance(pt, tc.MatrixProductState)
    assert pt.site_inds == psi0.site_inds and pt.dtype == torch.complex128
    assert abs(complex(tc.expec_TN_1D(pt.H, pt)) - 1) < 1e-10
    tebd.pt = psi0
    assert tebd._vidal is None
    assert np.allclose(_dense(tebd.pt).ravel(), _dense(psi0).ravel())


def test_trotterized_propagator():
    """The first-order propagator MPO against quimb_tpu's and against the
    product of the dense gates."""
    L, x = 5, -0.1j
    lh = quimb_torch.ham_1d_heis(L)
    got = lh.build_mpo_propagator_trotterized(x, device=CPU)
    want = qtn.ham_1d_heis(L).build_mpo_propagator_trotterized(x)
    np.testing.assert_allclose(_dense(got), _dense(want), rtol=0,
                               atol=1e-12)
    U = np.eye(2**L, dtype=complex)
    for parity in (0, 1):
        for i in range(parity, L - 1, 2):
            g = _n(lh.get_gate_expm((i, i + 1), x, device=CPU))
            U = np.kron(np.kron(np.eye(2**i), g), np.eye(2 ** (L - i - 2))) @ U
    np.testing.assert_allclose(_dense(got), U, rtol=0, atol=1e-12)


def test_otoc_local():
    L = 4
    Z = np.diag([1.0, -1.0]).astype(complex)
    X = np.array([[0, 1], [1, 0]], dtype=complex)
    kw = dict(dt=0.1, split_opts={"cutoff": 1e-12})
    psi = qtn.MPS_computational_state("0101")
    H = qtn.ham_1d_heis(L)
    Hb = qtn.ham_1d_heis(L, j=-1.0)
    want = list(jtebd.OTOC_local(
        psi, H, Hb, [0.2], 0, Z, j=3, B=X, **kw))
    got = list(quimb_torch.OTOC_local(
        from_tpu_mps(psi, device=CPU, dtype=torch.complex128),
        quimb_torch.ham_1d_heis(L), quimb_torch.ham_1d_heis(L, j=-1.0),
        [0.2], 0, torch.as_tensor(Z), j=3, B=torch.as_tensor(X), **kw))
    # two evolutions of 2 steps each way, complex128
    np.testing.assert_allclose(got, want, rtol=1e-9)
