"""quimb_torch's 2D evolution (``tensor/tn2d/tebd.py``: ``LocalHam2D``,
the ``ham_2d_*`` builders, ``TEBD2D`` and ``SimpleUpdate``) against
quimb_tpu's, in float64 on the CPU.

Both packages start from one PEPS (carried across with
``convert.from_tpu_peps``). The updates' factors carry a gauge that
differs between LAPACK under JAX and under torch, so the tests compare
gauge-free quantities: the gauge vectors (singular values), energies and
dense states. Tolerances: 1e-10 relative for float64 quantities after a
few sweeps of QR / SVD steps, unless a test says otherwise.
"""


import numpy as np
import pytest
import torch

import quimb_tpu.tensor as jtn
import quimb_torch.tensor as ttn
from quimb_torch import convert
from quimb_torch.tensor.tn2d import tebd as tt
from quimb_tpu.ops.contraction import contract_backend as jbackend

CPU = "cpu"
TOL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the updates are many tiny factorizations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _n(x):
    x = getattr(x, "data", x)
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().numpy()
    return np.asarray(x)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def _arrays(Lx, Ly, D, seed, cplx=False):
    rng = np.random.default_rng(seed)

    def draw(shape):
        x = rng.standard_normal(shape)
        return x + 1j * rng.standard_normal(shape) if cplx else x

    return [[draw([D] * sum((i < Lx - 1, j < Ly - 1, i > 0, j > 0)) + [2])
             for j in range(Ly)] for i in range(Lx)]


def _pair(Lx, Ly, D, seed, cplx=False):
    j = jtn.PEPS(_arrays(Lx, Ly, D, seed, cplx), shape="urdlp")
    return j, convert.from_tpu_peps(j, device=CPU)


HAMS = [
    ("ham_2d_heis", {}), ("ham_2d_heis", {"j": (1.0, 0.5, 0.2), "bz": 0.3}),
    ("ham_2d_ising", {"bx": 0.7}), ("ham_2d_ising", {}),
    ("ham_2d_j1j2", {"j2": 0.3}),
]


@pytest.mark.parametrize("name,kwargs", HAMS)
def test_ham_2d_builders_match(name, kwargs):
    """Every term of each builder equals quimb_tpu's (1e-14), on host
    arrays."""
    th = getattr(ttn, name)(3, 3, **kwargs)
    jh = getattr(jtn, name)(3, 3, **kwargs)
    assert set(th.terms) == set(jh.terms)
    for k, h in th.terms.items():
        assert isinstance(h, np.ndarray)
        assert np.allclose(h, np.asarray(jh.terms[k]), atol=1e-14)
    assert th.nsites == 9 and repr(th) == repr(jh)


@pytest.mark.parametrize("x", [-0.1, 0.2j, -0.05 + 0.1j])
def test_gate_expm_matches(x):
    """``get_gate_expm`` equals quimb_tpu's, real for a real factor on a
    real term, and is cached."""
    th, jh = ttn.ham_2d_heis(2, 2, bz=0.2), jtn.ham_2d_heis(2, 2, bz=0.2)
    where = ((0, 0), (0, 1))
    U = th.get_gate_expm(where, x)
    ref = np.asarray(jh.get_gate_expm(where, x))
    assert np.allclose(U, ref, atol=1e-14)
    assert np.iscomplexobj(U) == np.iscomplexobj(ref)
    # a real factor on a real term keeps the gate real
    assert not np.iscomplexobj(ttn.ham_2d_heis(2, 2).get_gate_expm(
        where, -0.1))
    assert th.get_gate_expm(where, x) is U
    # the reversed pair reads the same term
    assert th.get_term(where[::-1]) is th.get_term(where)


def test_expm_herm_is_the_matrix_exponential():
    from scipy.linalg import expm

    rng = np.random.default_rng(2)
    A = rng.standard_normal((4, 4))
    H = A + A.T
    got = tt._expm_herm(torch.as_tensor(H), -0.3)
    assert np.allclose(_n(got), expm(-0.3 * H), atol=1e-12)


@pytest.mark.parametrize("Lx,Ly,D,steps,cplx", [
    (3, 3, 2, 4, False), (2, 4, 3, 3, False), (3, 3, 2, 3, True)])
def test_simple_update_fused_matches(Lx, Ly, D, steps, cplx):
    """The fused SimpleUpdate of a real or a complex PEPS: every gauge
    vector, the simple energy and the boundary energy equal quimb_tpu's."""
    j, t = _pair(Lx, Ly, D, seed=Lx * 10 + Ly, cplx=cplx)
    jsu = jtn.SimpleUpdate(j, jtn.ham_2d_heis(Lx, Ly), D=D, chi=16,
                           compute_energy_every=None,
                           compute_energy_final=False)
    tsu = ttn.SimpleUpdate(t, ttn.ham_2d_heis(Lx, Ly), D=D, chi=16,
                           compute_energy_every=None,
                           compute_energy_final=False)
    assert tsu._can_fuse()
    for tau in (0.3, 0.1):
        jsu.evolve(steps, tau=tau)
        tsu.evolve(steps, tau=tau)
    assert tsu._fstacks is not None  # still the stacks until read
    assert tsu.n == jsu.n == 2 * steps and tsu.taus == jsu.taus
    assert set(tsu.gauges) == set(jsu.gauges)
    assert tsu._fstacks is None
    for k, s in tsu.gauges.items():
        assert np.allclose(_n(s), np.asarray(jsu.gauges[k]), atol=TOL)
    assert _rel(tsu.compute_energy_simple(), jsu.compute_energy_simple()) \
        < TOL
    assert _rel(tsu.compute_energy(), jsu.compute_energy()) < TOL


def test_simple_update_per_bond_matches():
    """``fused=False`` runs the per-bond path, as quimb_tpu's."""
    j, t = _pair(2, 3, 2, seed=5)
    kw = dict(D=2, chi=16, compute_energy_every=None,
              compute_energy_final=False)
    jsu = jtn.SimpleUpdate(j, jtn.ham_2d_heis(2, 3), **kw)
    tsu = ttn.SimpleUpdate(t, ttn.ham_2d_heis(2, 3), **kw)
    jsu.evolve(3, tau=0.2, fused=False)
    tsu.evolve(3, tau=0.2, fused=False)
    assert tsu._fstacks is None
    for k, s in tsu.gauges.items():
        assert np.allclose(_n(s), np.asarray(jsu.gauges[k]), atol=TOL)
    assert _rel(tsu.compute_energy_simple(), jsu.compute_energy_simple()) \
        < TOL
    assert _rel(tsu.compute_energy(method="boundary"),
                jsu.compute_energy(method="boundary")) < TOL


def test_get_state_matches():
    """``get_state`` absorbs the gauges: its dense state equals quimb_tpu's
    up to the norm (1e-10 in the overlap), and every site has unit
    norm."""
    j, t = _pair(3, 2, 2, seed=7)
    kw = dict(D=2, compute_energy_every=None, compute_energy_final=False)
    jsu = jtn.SimpleUpdate(j, jtn.ham_2d_heis(3, 2), **kw)
    tsu = ttn.SimpleUpdate(t, ttn.ham_2d_heis(3, 2), **kw)
    jsu.evolve(5, tau=0.2)
    tsu.evolve(5, tau=0.2)
    psi = tsu.get_state()
    assert isinstance(psi, ttn.PEPS)
    for x in psi:
        assert abs(float(torch.linalg.vector_norm(x.data)) - 1) < 1e-12
    a = _n(psi.to_dense()).reshape(-1)
    b = _n(jsu.get_state().to_dense()).reshape(-1)
    assert abs(abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b)) - 1) \
        < TOL
    # absorb_gauges=False is the bare state
    bare = tsu.get_state(absorb_gauges=False)
    assert bare.num_tensors == 6


def test_energy_every_and_callback():
    """``compute_energy_every`` and ``compute_energy_final`` record the
    energies quimb_tpu records; the callback is called."""
    j, t = _pair(2, 2, 2, seed=8)
    seen = []
    kw = dict(D=2, chi=8, compute_energy_every=2,
              compute_energy_final=True)
    jsu = jtn.SimpleUpdate(j, jtn.ham_2d_heis(2, 2), **kw)
    tsu = ttn.SimpleUpdate(t, ttn.ham_2d_heis(2, 2), callback=seen.append,
                           **kw)
    jsu.evolve(4, tau=0.1, fused=False)
    tsu.evolve(4, tau=0.1, fused=False)
    assert len(tsu.energies) == len(jsu.energies) == 3
    assert np.allclose(tsu.energies, jsu.energies, rtol=TOL)
    assert seen == [tsu, tsu] and tsu.energy == tsu.energies[-1]


def test_can_fuse_follows_the_geometry():
    """Diagonal terms, a truncation other than D or a 1-wide lattice take
    the per-bond path."""
    _, t = _pair(3, 3, 2, seed=9)
    kw = dict(compute_energy_every=None, compute_energy_final=False)
    assert ttn.SimpleUpdate(t, ttn.ham_2d_heis(3, 3), D=2, **kw)._can_fuse()
    assert not ttn.SimpleUpdate(t, ttn.ham_2d_j1j2(3, 3), D=2,
                                **kw)._can_fuse()
    assert not ttn.SimpleUpdate(t, ttn.ham_2d_heis(3, 3), D=2,
                                gate_opts={"max_bond": 3}, **kw)._can_fuse()
    _, line = _pair(1, 3, 2, seed=9)
    assert not ttn.SimpleUpdate(line, ttn.ham_2d_heis(1, 3), D=2,
                                **kw)._can_fuse()


def test_tebd2d_matches():
    """The plain gate-by-gate ``TEBD2D`` (reduce-split at D) gives
    quimb_tpu's state (dense, 1e-10 in the overlap) and energy."""
    j, t = _pair(2, 2, 2, seed=10)
    kw = dict(D=2, chi=8, compute_energy_every=None,
              compute_energy_final=True)
    jte = jtn.TEBD2D(j, jtn.ham_2d_heis(2, 2), **kw)
    tte = ttn.TEBD2D(t, ttn.ham_2d_heis(2, 2), **kw)
    jte.evolve(3, tau=0.1)
    tte.evolve(3, tau=0.1)
    a = _n(tte.state.to_dense()).reshape(-1)
    b = _n(jte.state.to_dense()).reshape(-1)
    assert abs(abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b)) - 1) \
        < TOL
    assert _rel(tte.energies[-1], jte.energies[-1]) < TOL
    assert tte.D == 2 and tte.chi == 8


def test_build_pepo_propagator_matches():
    """The first-order propagator as a PEPO equals quimb_tpu's (dense,
    1e-12)."""
    th, jh = ttn.ham_2d_heis(2, 2), jtn.ham_2d_heis(2, 2)
    tp = th.build_pepo_propagator_trotterized(-0.1, device=CPU)
    jp = jh.build_pepo_propagator(-0.1)
    assert np.allclose(_n(tp.to_dense()), np.asarray(jp.to_dense()),
                       atol=1e-12)


def test_simple_update_with_host_arrays():
    """Inside ``contract_backend("numpy")`` the per-bond path of quimb_tpu
    runs on host arrays; the port's CPU tensors reach its values."""
    j, t = _pair(2, 2, 2, seed=11)
    kw = dict(D=2, compute_energy_every=None, compute_energy_final=False)
    jsu = jtn.SimpleUpdate(j, jtn.ham_2d_heis(2, 2), **kw)
    with jbackend("numpy"):
        jsu.state.apply_to_arrays(np.asarray)
        jsu.evolve(2, tau=0.1, fused=False)
        want = jsu.compute_energy_simple()
    tsu = ttn.SimpleUpdate(t, ttn.ham_2d_heis(2, 2), **kw)
    tsu.evolve(2, tau=0.1, fused=False)
    assert _rel(tsu.compute_energy_simple(), want) < TOL


def _full_update_gate(j, t):
    """One ALS gate of FullUpdate on the port and on quimb_tpu (host
    arrays): the same energy afterwards (float64 normal equations of a
    2 x 2 plaquette, round-off)."""
    kw = dict(D=2, chi=8, compute_energy_final=False)
    with jbackend("numpy"):
        jfu = jtn.FullUpdate(j, jtn.ham_2d_heis(2, 2), **kw)
        jfu.state.apply_to_arrays(np.asarray)
        U = np.asarray(jfu.ham.get_gate_expm(((0, 0), (0, 1)), -0.3))
        jfu.gate(U, ((0, 0), (0, 1)))
        want = float(np.real(jfu.compute_energy()))
    tfu = ttn.FullUpdate(t, ttn.ham_2d_heis(2, 2), **kw)
    tfu.gate(tfu.ham.get_gate_expm(((0, 0), (0, 1)), -0.3),
             ((0, 0), (0, 1)))
    assert _rel(tfu.compute_energy(), want) < TOL


def _fitter_reaches_quimb_tpus(j, t):
    """The autodiff fitter reaches quimb_tpu's fidelity on a random
    problem (both L-BFGS, different line searches: 1e-8 relative)."""
    import jax.numpy as jnp

    from quimb_tpu.tensor.tn2d import tebd as jtb

    rng = np.random.default_rng(3)
    xa, xb = rng.normal(size=(2, 2, 2)), rng.normal(size=(2, 2, 2))
    A = rng.normal(size=(4, 4))
    E = A @ A.T + 0.1 * np.eye(4)
    ET = E @ rng.normal(size=(4, 4))
    perm = (0, 2, 1, 3)

    def loss(a, b):
        f = np.tensordot(a, b, axes=([1], [0])).transpose(perm)
        f = f.reshape(4, 4)
        return -np.trace(f.T @ ET) ** 2 / np.trace(f.T @ E @ f)

    ja, jb = jtb._autodiff_plaquette_fitter(1, 0, perm, 4, 4, 48)(
        *map(jnp.asarray, (xa, xb, E, ET)))
    ta, tb = tt._autodiff_plaquette_fitter(1, 0, perm, 4, 4, 48)(
        *map(torch.from_numpy, (xa, xb, E, ET)))
    want = loss(np.asarray(ja), np.asarray(jb))
    assert loss(ta.numpy(), tb.numpy()) <= want * (1 - 1e-8)


def _set_state_copies(j, t):
    fu = ttn.FullUpdate(t, ttn.ham_2d_heis(2, 2), D=2)
    _, other = _pair(2, 2, 2, seed=1)
    assert fu.set_state(other) is fu
    assert fu.state is not other
    assert all(torch.equal(fu.state[tag].data, other[tag].data)
               for tag in other.site_tags)


def _presweep_returns_self(j, t):
    fu = ttn.FullUpdate(t, ttn.ham_2d_heis(2, 2), D=2)
    assert fu.presweep() is fu


@pytest.mark.parametrize("call", [
    _full_update_gate,
    _fitter_reaches_quimb_tpus,
    _set_state_copies,
    _presweep_returns_self,
])
def test_full_update_names_its_item(call):
    """FullUpdate, its fitter, ``set_state`` and ``presweep``: once left
    out naming their ROADMAP item, now ported (the name is kept)."""
    j, t = _pair(2, 2, 2, seed=0)
    call(j, t)
