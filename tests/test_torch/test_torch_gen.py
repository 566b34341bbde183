"""quimb_torch's ``gen/`` (operators, states, random objects), ``gates.py``
and the MBL builders of ``tn1d`` against quimb_tpu's, on the CPU.

Everything built from numpy constants or ``np.random.default_rng`` is
compared value for value (1e-14 absolute; ``ham_mbl``'s fields and the
random product state are the same draws). Objects that quimb_tpu draws
from JAX's PRNG (``rand_uni``, ``rand_ket``, ``rand_rho``, ...) cannot be
matched draw for draw: their properties are tested instead, and the Haar
moments of kets and unitaries over 1000 draws (d = 4: E|x|^2 = 1/4 and
E|x|^4 = 1/10, held to 4 standard errors)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import quimb_tpu.gates as jgates
import quimb_tpu.gen.operators as jops
import quimb_tpu.gen.rand as jrand
import quimb_tpu.gen.states as jstates
import quimb_tpu.tensor.tn1d.builders as jb
from quimb_torch.gen import operators as ops
from quimb_torch.gen import rand as trand
from quimb_torch.gen import states
from quimb_torch.ops import backend
from quimb_torch.tensor.tn1d import builders as tb

CPU = "cpu"


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, atol=1e-14):
    if sp.issparse(got):
        got, want = got.toarray(), want.toarray()
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


GATES = [
    ("hadamard", ()), ("phase_gate", (0.3,)), ("S_gate", ()),
    ("T_gate", ()), ("rotation", (0.7, "X")), ("Rx", (0.2,)),
    ("Ry", (0.4,)), ("Rz", (1.1,)), ("U_gate", (0.1, 0.2, 0.3)),
    ("Xsqrt", ()), ("Ysqrt", ()), ("Zsqrt", ()), ("Wsqrt", ()),
    ("swap", ()), ("swap", (3,)), ("iswap", ()), ("fsim", (0.3, 0.5)),
    ("fsimg", (0.1, 0.2, 0.3, 0.4, 0.5)), ("controlled", ("y",)),
    ("CNOT", ()), ("cX", ()), ("cY", ()), ("cZ", ()), ("ccX", ()),
    ("ccY", ()), ("ccZ", ()), ("toffoli", ()), ("fredkin", ()),
    ("cswap", ()), ("shift", (4, 3)), ("clock", (3, 2)),
    ("identity", (3,)), ("pauli", ("Y",)), ("pauli", ("Z", 3)),
    ("spin_operator", ("+", 1.0)), ("create", (4,)), ("destroy", (4,)),
    ("num", (4,)), ("ncontrolled_gate", (2, np.array([[0, 1], [1, 0]]))),
]


@pytest.mark.parametrize("name,args", GATES)
def test_gates_and_small_operators(name, args):
    _close(getattr(ops, name)(*args, device=CPU), getattr(jops, name)(*args))


HAMS = [
    ("ham_XXZ", (6, 0.4), dict(jxy=0.8, cyclic=True)),
    ("ham_mbl", (6, 1.5), dict(seed=7)),
    ("ham_mbl", (5, 0.7), dict(seed=3, dh_dist="g", dh_dim=3,
                               cyclic=True)),
    ("ham_j1j2", (6,), dict(j1=1.0, j2=0.4, bz=0.1)),
    ("ham_j1j2", (6,), dict(cyclic=True)),
    ("ham_hubbard_hardcore", (5,), dict(t=0.4, V=0.9, mu=0.3)),
    ("ham_heis_2D", (2, 3), dict(j=(1.0, 0.8, 0.6), bz=0.2)),
    ("ham_heis_2D", (2, 3), dict(cyclic=True)),
]


@pytest.mark.parametrize("name,args,kw", HAMS)
def test_hamiltonians(name, args, kw):
    _close(getattr(ops, name)(*args, device=CPU, **kw),
           getattr(jops, name)(*args, **kw), atol=1e-13)
    _close(getattr(ops, name)(*args, sparse=True, **kw),
           getattr(jops, name)(*args, sparse=True, **kw), atol=1e-13)


def test_zspin_projector():
    for n, sz in ((4, 0), (5, 0.5), (6, (1, -1))):
        P = ops.zspin_projector(n, sz, device=CPU)
        assert P.dtype == torch.float64
        _close(P, jops.zspin_projector(n, sz))
    with pytest.raises(ValueError):
        ops.zspin_projector(4, 0.5, device=CPU)


STATES = [
    ("plus", ()), ("minus", ()), ("yplus", ()), ("yminus", ()),
    ("up", ()), ("down", ()), ("bloch_state", (0.2, -0.3, 0.5)),
    ("bloch_state", (0.2, -0.3, 0.5, True)), ("bell_state", ("phi+",)),
    ("bell_state", (1,)), ("singlet", ()), ("singlet_pairs", (4,)),
    ("werner_state", (0.3,)), ("ghz_state", (4,)), ("w_state", (4,)),
    ("neel_state", (5,)), ("computational_state", ("0110",)),
    ("graph_state_1d", (5,)), ("graph_state_1d", (4, False)),
    ("basis_vec", (3, 8)),
]


@pytest.mark.parametrize("name,args", STATES)
def test_states(name, args):
    _close(getattr(states, name)(*args, device=CPU),
           getattr(jstates, name)(*args), atol=1e-14)


def test_thermal_perm_and_levi_civita():
    rng = np.random.default_rng(0)
    H = rng.standard_normal((6, 6))
    H = H + H.T
    _close(states.thermal_state(torch.as_tensor(H), 0.7),
           jstates.thermal_state(H, 0.7), atol=1e-13)
    f = states.thermal_state(torch.as_tensor(H), None, precomp_func=True)
    _close(f(1.3), jstates.thermal_state(H, 1.3), atol=1e-13)
    for perm in ((0, 1, 2), (1, 0, 2), (2, 0, 1), (3, 2, 1, 0)):
        assert states.levi_civita(perm) == jstates.levi_civita(perm)
    kets = [states.up(device=CPU), states.plus(device=CPU),
            states.yplus(device=CPU)]
    jkets = [jstates.up(), jstates.plus(), jstates.yplus()]
    _close(states.perm_state(kets), jstates.perm_state(jkets), atol=1e-14)


def test_random_objects_drawn_by_numpy_match():
    _close(trand.rand_product_state(5, seed=3, device=CPU),
           jrand.rand_product_state(5, seed=3))
    _close(trand.rand_herm(20, sparse=True, density=0.2, seed=4),
           jrand.rand_herm(20, sparse=True, density=0.2, seed=4))
    assert trand.rand_mix(3, 2, 5, seed=6, device=CPU).shape == (3, 3)


def _haar_moments(xs):
    a2 = np.abs(np.asarray(xs)) ** 2
    return a2.mean(), (a2**2).mean(), (a2**2).std() / np.sqrt(len(xs)), \
        a2.std() / np.sqrt(len(xs))


def test_random_objects_properties_and_haar_moments():
    d = 4
    U = trand.rand_uni(d, seed=1, device=CPU)
    _close(U.conj().T @ U, np.eye(d), atol=1e-13)
    k = trand.rand_ket(6, seed=2, device=CPU)
    assert k.shape == (6, 1) and float(torch.linalg.norm(k)) == \
        pytest.approx(1.0, abs=1e-14)
    rho = trand.rand_rho(5, seed=3, device=CPU)
    _close(rho, rho.conj().T, atol=1e-15)
    assert complex(torch.trace(rho)) == pytest.approx(1.0, abs=1e-14)
    assert float(torch.linalg.eigvalsh(rho)[0]) >= -1e-14
    assert float(torch.linalg.eigvalsh(trand.rand_pos(5, seed=4,
                                                      device=CPU))[0]) >= 0
    H = trand.rand_herm(5, seed=5, device=CPU)
    _close(H, H.conj().T, atol=0)
    V = trand.rand_iso(6, 3, seed=6, device=CPU)
    _close(V.conj().T @ V, np.eye(3), atol=1e-13)
    mix = trand.rand_mix(4, seed=7, device=CPU)
    assert complex(torch.trace(mix)) == pytest.approx(1.0, abs=1e-13)
    sep = trand.rand_seperable((2, 3), num_mix=4, seed=8, device=CPU)
    assert complex(torch.trace(sep)) == pytest.approx(1.0, abs=1e-13)
    assert float(torch.linalg.eigvalsh(sep)[0]) >= -1e-13
    m = trand.rand_matrix(50, seed=9, device=CPU)
    assert float(torch.mean(torch.abs(m) ** 2)) == pytest.approx(
        1 / 100, rel=0.1)
    assert torch.equal(trand.rand_uni(d, seed=1, device=CPU), U)
    assert set(_np(trand.rand_rademacher(50, seed=1, device=CPU))) == {-1,
                                                                      1}
    r = trand.rand((100,), dtype=torch.float64, seed=2, device=CPU)
    assert -0.5 <= float(r.min()) and float(r.max()) < 0.5
    assert len(list(trand.gen_rand_haar_states(3, 4, device=CPU))) == 4
    trand.seed_rand(11)
    kets = np.stack([_np(trand.rand_haar_state(d, device=CPU))[:, 0]
                     for _ in range(1000)])
    unis = np.stack([_np(trand.rand_uni(d, device=CPU))[0, 0]
                     for _ in range(1000)])
    for xs in (kets[:, 0], unis):
        m2, m4, e4, e2 = _haar_moments(xs)
        assert abs(m2 - 1 / d) <= 4 * e2
        assert abs(m4 - 2 / (d * (d + 1))) <= 4 * e4
    psi = trand.rand_matrix_product_state(6, 3, seed=2, device=CPU)
    assert psi.shape == (64, 1)
    assert float(torch.linalg.norm(psi)) == pytest.approx(1.0, abs=1e-12)
    assert np.linalg.matrix_rank(_np(psi).reshape(8, 8)) <= 3
    assert trand.rand_mera(8, seed=1, device=CPU).L == 8


def test_gates_module(monkeypatch):
    """The constant gates, made on the default device when first read."""
    import quimb_torch.gates as tgates

    monkeypatch.setattr(backend, "DEFAULT_DEVICE", torch.device("cpu"))
    monkeypatch.setattr(tgates, "_MADE", {})
    for name in ("I", "X", "Y", "Z", "H", "S", "T", "W", "SWAP", "ISWAP",
                 "CX", "CY", "CZ", "CCX", "CCNOT", "CSWAP"):
        _close(getattr(tgates, name), getattr(jgates, name))
    assert tgates.X is tgates.X
    with pytest.raises(AttributeError):
        tgates.NOT_A_GATE


def test_mbl_builders():
    """``MPO_ham_mbl`` and ``ham_1d_mbl``: the same fields from
    ``default_rng(seed)``, the same MPO and local terms."""
    for kw in (dict(seed=5), dict(seed=6, dh_dist="g", cyclic=False)):
        mt = tb.MPO_ham_mbl(6, 0.8, device=CPU, **kw)
        mj = jb.MPO_ham_mbl(6, 0.8, **kw)
        _close(mt.to_dense(), mj.to_dense(), atol=1e-13)
        lt, lj = tb.ham_1d_mbl(6, 0.8, **kw), jb.ham_1d_mbl(6, 0.8, **kw)
        assert lt.terms.keys() == lj.terms.keys()
        for key in lt.terms:
            _close(lt.terms[key], lj.terms[key], atol=1e-14)
