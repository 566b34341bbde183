"""quimb_torch's MPS / MPO object layer (``tensor/tn1d/core.py`` and the
compression methods of ``tn1d/compress.py``) against quimb_tpu's, in
float64 / complex128 on the CPU.

The states cross from quimb_tpu with ``convert.from_tpu_mps`` /
``from_tpu_mpo`` (the same arrays, index names and tags). Canonical
forms and splits carry a gauge (the signs or phases of QR and SVD
factors) that differs between LAPACK under JAX and under torch, so the
tests compare gauge-free quantities: norms, expectations, Schmidt
values, dense states and operators, amplitudes and samples drawn with
one seed. Tolerances: 1e-12 relative for float64 contractions of a few
hundred terms, unless a test says otherwise.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quimb_tpu.tensor as qtn
from quimb_tpu.tensor import core as jcore
from quimb_tpu.tensor.tn1d import core as jc
from quimb_torch.convert import from_tpu_mpo, from_tpu_mps
from quimb_torch.tensor import core as tcore
from quimb_torch.tensor.tn1d import compress as tcomp
from quimb_torch.tensor.tn1d import core as tc

CPU = "cpu"
TOL = 1e-12


def _n(x):
    """A scalar, array, tensor or Tensor of either package as numpy."""
    x = getattr(x, "data", x)
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().numpy()
    return np.asarray(x)


def _c(x):
    return complex(_n(x).reshape(()))


def _close(a, b, tol=TOL):
    a, b = _n(a), _n(b)
    return np.linalg.norm(a - b) <= tol * max(np.linalg.norm(b), 1e-300)


def _pair(L=8, chi=6, seed=3, cyclic=False, dtype="float64"):
    """quimb_tpu's random MPS and the port's copy of it."""
    j = qtn.MPS_rand_state(L, chi, seed=seed, cyclic=cyclic, dtype=dtype)
    return j, from_tpu_mps(j, device=CPU)


def _mpo_pair(L=8, cyclic=False):
    j = qtn.MPO_ham_heis(L, cyclic=cyclic)
    return j, from_tpu_mpo(j, device=CPU)


def _dense_state(psi):
    return _n(psi.to_dense()).reshape(-1)


def _phase_close(a, b, tol=1e-10):
    """Two state vectors equal up to a global phase."""
    a, b = _n(a).reshape(-1), _n(b).reshape(-1)
    ph = np.vdot(a, b)
    ph = ph / abs(ph) if abs(ph) > 0 else 1.0
    return np.linalg.norm(a * ph - b) <= tol * np.linalg.norm(b)


def _dense_apply(v, U, sites, L):
    """The dense gate ``U`` on ``sites`` of the L-qubit vector ``v``."""
    k = len(sites)
    x = np.moveaxis(v.reshape((2,) * L), sites, range(k))
    x = (U @ x.reshape(2**k, -1)).reshape((2,) * L)
    return np.moveaxis(x, range(k), sites).reshape(-1)


# -- expec_TN_1D --------------------------------------------------------------


@pytest.mark.parametrize("cyclic", [False, True])
def test_expec_matches(cyclic):
    """The left-to-right sandwich against quimb_tpu's, on the norm and on
    <psi|H|psi> (quimb_tpu's operands aligned by hand: its align_TN_1D
    fuses an operator's two physical indices, ROADMAP §3)."""
    j, t = _pair(L=8, chi=4, cyclic=cyclic)
    assert _close(tc.expec_TN_1D(t.H, t), jc.expec_TN_1D(j.H, j))
    jH, tH = _mpo_pair(8, cyclic=cyclic)
    jk = j.reindex_sites("x{}")
    jH2 = jH.reindex({jH.lower_ind(i): f"x{i}" for i in range(8)})
    want = jc.expec_TN_1D(j.H, jH2, jk)
    got = tc.expec_TN_1D(*tc.align_TN_1D(t.H, tH, t))
    assert _close(got, want)
    # and against the dense form
    v = _dense_state(t)
    Hd = _n(tH.to_dense())
    assert abs(_c(got) - np.vdot(v, Hd @ v)) <= TOL * abs(_c(got))


def test_expec_intermediates_stay_at_env_times_site(monkeypatch):
    """At L=10, chi=16 the port's largest intermediate is an environment
    times one site tensor, chi^2 w d entries; quimb_tpu's column merge
    builds a bra-ket outer product of chi^4 entries (ROADMAP §3)."""
    L, chi = 10, 16
    j, t = _pair(L=L, chi=chi, seed=5)
    jH, tH = _mpo_pair(L)
    sizes = []
    plain = tc.tensor_contract

    def counted(*ts, **kw):
        out = plain(*ts, **kw)
        sizes.append(out.size)
        return out

    monkeypatch.setattr(tc, "tensor_contract", counted)
    got = tc.expec_TN_1D(*tc.align_TN_1D(t.H, tH, t))
    w, d = 5, 2
    assert max(sizes) <= chi * chi * w * d
    # quimb_tpu's: the column tensors its contract_tags builds
    jsizes = []
    jplain = jcore.tensor_contract

    def jcounted(*ts, **kw):
        out = jplain(*ts, **kw)
        jsizes.append(getattr(out, "size", 1))
        return out

    monkeypatch.setattr(jcore, "tensor_contract", jcounted)
    want = jc.expec_TN_1D(j.H, j)
    assert max(jsizes) >= chi**4
    assert _close(tc.expec_TN_1D(t.H, t), want)
    assert np.isfinite(_c(got))


# -- canonical forms and compression ------------------------------------------


@pytest.mark.parametrize("where", [0, 3, 7])
def test_canonize_and_orthog_center(where):
    j, t = _pair()
    n0 = _c(t.H @ t)
    t.canonize(where)
    assert t.calc_current_orthog_center() == (where, where)
    assert abs(_c(t.H @ t) - n0) <= TOL
    c = t[t.site_tag(where)]
    assert abs(_c(c.norm()) ** 2 - n0) <= 1e-10
    t.shift_orthogonality_center(where, 5)
    assert t.calc_current_orthog_center() == (5, 5)
    nl, nr = t.count_canonized()
    assert (nl, nr) == (5, 2)
    assert _phase_close(_dense_state(t), _dense_state(j))


def test_left_right_canonize_normalize():
    j, t = _pair()
    t.left_canonize(normalize=True)
    assert abs(_c(t.H @ t) - 1) <= TOL
    t2 = from_tpu_mps(j, device=CPU)
    bra = t2.H
    t2.right_canonize(bra=bra)
    assert abs(_c(bra @ t2) - _c(j.H @ j)) <= TOL
    assert all(t2._site_is_right_canonical(i) for i in range(1, 8))


@pytest.mark.parametrize("form", ["left", "right", 4])
def test_compress_forms(form):
    """``compress`` to each form with a truncation: the same Schmidt
    values, norm and dense state as quimb_tpu's."""
    j, t = _pair(L=8, chi=8, seed=11)
    j.compress(form=form, max_bond=4, cutoff=0.0)
    t.compress(form=form, max_bond=4, cutoff=0.0)
    assert t.bond_sizes() == j.bond_sizes()
    assert _close(t.H @ t, j.H @ j, 1e-10)
    assert _phase_close(_dense_state(t), _dense_state(j), 1e-9)
    assert _close(t.schmidt_values(4), j.schmidt_values(4), 1e-9)


def test_compress_site_and_bond_functions():
    j, t = _pair(L=8, chi=8, seed=12)
    assert t.bond_sizes() == j.bond_sizes()
    assert t.bond_size(3, 4) == j.bond_size(3, 4)
    assert t.bond(3, 4) == j.bond(3, 4)
    j.compress_site(4, max_bond=3, cutoff=0.0)
    t.compress_site(4, max_bond=3, cutoff=0.0)
    assert t.bond_sizes() == j.bond_sizes()
    assert _close(t.H @ t, j.H @ j, 1e-10)
    t.left_compress(max_bond=2, cutoff=0.0)
    assert max(t.bond_sizes()) == 2
    t.right_compress(max_bond=2, cutoff=0.0)
    assert max(t.bond_sizes()) == 2
    assert t.show() == "●─2─●─2─●─2─●─2─●─2─●─2─●─2─●"


def test_expand_bond_dimension_and_amplitude():
    j, t = _pair(L=6, chi=4)
    v = _dense_state(t)
    t2 = t.expand_bond_dimension(7, inplace=False)
    assert max(t2.bond_sizes()) == 7 and max(t.bond_sizes()) == 4
    assert np.allclose(_dense_state(t2), v, atol=1e-14)
    for b in [(0, 1, 1, 0, 1, 0), (1, 1, 1, 1, 1, 1)]:
        want = _c(j.amplitude(b))
        got = _c(t.amplitude(b))
        assert abs(got - want) <= TOL * abs(want)
        assert abs(got - v[int("".join(map(str, b)), 2)]) <= TOL * abs(want)


def test_singular_values_entropy_gap():
    j, t = _pair(L=8, chi=8, seed=13)
    for i in (2, 4, 6):
        assert _close(t.schmidt_values(i), j.schmidt_values(i), 1e-12)
        assert t.entropy(i) == pytest.approx(j.entropy(i), abs=1e-12)
        assert t.schmidt_gap(i) == pytest.approx(j.schmidt_gap(i),
                                                 abs=1e-12)
    assert _close(t.singular_values(4), j.singular_values(4), 1e-12)
    with pytest.raises(ValueError):
        t.schmidt_values(0)


# -- gating and expectations ---------------------------------------------------


def _rand_unitary(rng, n):
    x = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    return np.linalg.qr(x)[0]


@pytest.mark.parametrize("contract", [False, True])
def test_gate(contract):
    """One- and two-site gates, lazy and contracted: the dense results."""
    rng = np.random.default_rng(20)
    j, t = _pair(L=6, dtype="complex128")
    v = _dense_state(t)
    G = _rand_unitary(rng, 2)
    tg = t.gate(torch.as_tensor(G), 3, contract=contract)
    assert np.allclose(_dense_state(tg), _dense_apply(v, G, (3,), 6),
                       atol=1e-13)
    G2 = _rand_unitary(rng, 4)
    t.gate_(torch.as_tensor(G2), (2, 5), contract=contract)
    assert np.allclose(_dense_state(t), _dense_apply(v, G2, (2, 5), 6),
                       atol=1e-13)
    assert t.num_tensors == (5 if contract else 7)


def test_gate_split_auto_swap_submpo():
    """Two-qubit gates by reduce-split, next to each other and apart, and
    a three-site MPO zipped in, with no truncation: the dense results
    (quimb_tpu's for the split)."""
    rng = np.random.default_rng(21)
    j, t = _pair(L=6, chi=4, dtype="complex128")
    U = _rand_unitary(rng, 4)
    v = _dense_state(t)
    t1 = t.gate_split(torch.as_tensor(U), (3, 4))
    j1 = j.gate_split(U, (3, 4))
    assert np.allclose(_dense_state(t1), _dense_state(j1), atol=1e-12)
    t2 = t.gate_with_auto_swap(torch.as_tensor(U), (1, 5))
    assert np.allclose(_dense_state(t2), _dense_apply(v, U, (1, 5), 6),
                       atol=1e-12)
    assert np.allclose(_dense_state(t), v)
    # an MPO on sites 2..4, zipped in and compressed
    jm = qtn.MPO_rand(3, 2, seed=7, dtype="complex128")
    tm = from_tpu_mpo(jm, device=CPU)
    t3 = t.gate_with_submpo(tm, where=(2, 3, 4))
    assert np.allclose(_dense_state(t3),
                       _dense_apply(v, _n(jm.to_dense()), (2, 3, 4), 6),
                       atol=1e-12)
    with pytest.raises(ValueError):
        t.gate_split(torch.as_tensor(U), (2, 5))


def test_magnetization_correlation():
    j, t = _pair(L=8, chi=6, seed=22)
    for i in (0, 4, 7):
        assert _c(t.magnetization(i)) == pytest.approx(
            _c(j.magnetization(i)), abs=1e-12)
    Sz = np.diag([0.5, -0.5])
    got = _c(t.correlation(torch.as_tensor(Sz), 2, 5))
    assert got == pytest.approx(_c(j.correlation(Sz, 2, 5)), abs=1e-12)
    terms = {3: Sz, (4, 5): np.kron(Sz, Sz)}
    assert t.compute_local_expectation(
        {k: torch.as_tensor(v) for k, v in terms.items()}) == \
        pytest.approx(complex(j.compute_local_expectation(terms)).real,
                      abs=1e-12)


@pytest.mark.parametrize("cyclic", [False, True])
def test_add_and_subtract(cyclic):
    j, t = _pair(L=6, chi=3, seed=23, cyclic=cyclic)
    j2, t2 = _pair(L=6, chi=3, seed=24, cyclic=cyclic)
    s, js = t + t2, j + j2
    assert s.cyclic == cyclic
    assert _close(s.H @ s, js.H @ js, 1e-11)
    d = t - t2
    assert np.allclose(_dense_state(d), _dense_state(t) - _dense_state(t2),
                       atol=1e-13)
    t.add_MPS_(t2)
    assert _close(t.H @ t, js.H @ js, 1e-11)


def test_partial_trace_measure_sample():
    j, t = _pair(L=8, chi=6, seed=25, dtype="complex128")
    assert _close(t.partial_trace((3, 4)), j.partial_trace((3, 4)), 1e-12)
    v = _dense_state(t).reshape(2, 2**6, 2)
    rho = np.einsum("axb,cxd->abcd", v, v.conj()).reshape(4, 4)
    assert _close(t.ptr((0, 7)), rho, 1e-12)
    out_t, pt = t.measure(3, seed=9)
    out_j, pj = j.measure(3, seed=9)
    assert out_t == out_j
    assert _phase_close(_dense_state(pt), _dense_state(pj), 1e-10)
    st = list(t.sample(6, seed=17))
    sj = list(j.sample(6, seed=17))
    assert [c for c, _ in st] == [c for c, _ in sj]
    for (_, wt), (_, wj) in zip(st, sj):
        assert wt == pytest.approx(wj, rel=1e-10)
    c, w = t.sample_configuration(seed=3)
    assert abs(abs(_c(t.amplitude(c))) ** 2 / _c(t.H @ t).real - w) < 1e-12


def test_log_norm_normalize_from_dense():
    j, t = _pair(L=10, chi=8, seed=26, dtype="complex128")
    t.multiply_(3.5)
    j.multiply_(3.5)
    assert t.log_norm() == pytest.approx(j.log_norm(), abs=1e-12)
    old = t.normalize()
    assert old == pytest.approx(3.5, rel=1e-12)
    assert abs(_c(t.H @ t) - 1) <= TOL
    v = _dense_state(t)
    f = tc.MatrixProductState.from_dense(v, device=CPU)
    assert f.bond_sizes() == [2, 4, 8, 8, 8, 8, 8, 4, 2]
    assert np.allclose(_dense_state(f), v, atol=1e-12)
    assert t.arrays_lrp[3].shape == j.arrays_lrp[3].shape


# -- MPO ------------------------------------------------------------------------


@pytest.mark.parametrize("cyclic", [False, True])
def test_mpo_apply_add_obc(cyclic):
    jH, tH = _mpo_pair(6, cyclic=cyclic)
    assert tH.cyclic == cyclic
    assert np.allclose(_n(tH.to_dense()), _n(jH.to_dense()), atol=1e-14)
    j, t = _pair(L=6, chi=4, seed=27)
    Hv = _n(tH.to_dense()) @ _dense_state(t)
    assert np.allclose(_dense_state(tH.apply(t)), Hv, atol=1e-12)
    Hd = _n(jH.to_dense())
    assert np.allclose(_n(tH.apply(tH).to_dense()), Hd @ Hd, atol=1e-12)
    s = tH + tH
    assert np.allclose(_n(s.to_dense()), 2 * _n(tH.to_dense()), atol=1e-13)
    d = tH - tH
    assert np.abs(_n(d.to_dense())).max() < 1e-13
    o = tH.to_obc()
    assert not o.cyclic
    assert np.allclose(_n(o.to_dense()), _n(tH.to_dense()), atol=1e-12)
    if cyclic:
        assert o.bond_sizes() == jH.to_obc().bond_sizes()


def test_mpo_trace_transpose_h_identity():
    jm = qtn.MPO_rand(4, 3, seed=8, dtype="complex128")
    tm = from_tpu_mpo(jm, device=CPU)
    A = _n(tm.to_dense())
    assert abs(_c(tm.trace()) - np.trace(A)) <= 1e-12 * abs(np.trace(A))
    assert np.allclose(_n(tm.H.to_dense()), A.conj().T, atol=1e-14)
    pt = _n(tm.partial_transpose((0, 2)).to_dense())
    want = _n(jm.partial_transpose((0, 2)).to_dense())
    assert np.allclose(pt, want, atol=1e-14)
    assert np.allclose(_n(tm.identity().to_dense()), np.eye(16))
    r = tm.rand_state(3, seed=1)
    assert r.L == 4 and r.site_ind_id == tm.upper_ind_id
    tm.add_MPO_(tm)
    assert np.allclose(_n(tm.to_dense()), 2 * A, atol=1e-13)


def test_mpo_from_dense_and_fill():
    rng = np.random.default_rng(28)
    A = rng.normal(size=(8, 8)) + 1j * rng.normal(size=(8, 8))
    m = tc.MatrixProductOperator.from_dense(A, device=CPU)
    assert np.allclose(_n(m.to_dense()), A, atol=1e-12)
    B = rng.normal(size=(4, 4))
    ms = tc.MatrixProductOperator.from_dense(B, sites=(1, 4), L=6,
                                             device=CPU)
    js = jc.MatrixProductOperator.from_dense(jnp.asarray(B), sites=(1, 4),
                                             L=6)
    assert ms.L == 6
    assert np.allclose(_n(ms.to_dense()), _n(js.to_dense()), atol=1e-12)
    part = tc.MatrixProductOperator.from_fill_fn(
        lambda s: torch.ones(s, dtype=torch.float64), 3, 2)
    del part[part.site_tag(1)]
    full = part.fill_empty_sites()
    assert full.num_tensors == 3


# -- the rest of the 1D layer ----------------------------------------------------


def test_dense1d_align_superop():
    rng = np.random.default_rng(29)
    v = rng.normal(size=2**5)
    d = tc.Dense1D(v, device=CPU)
    assert d.L == 5 and d.num_tensors == 1
    j, t = _pair(L=5, chi=4, seed=30)
    assert _c(tc.expec_TN_1D(d.H, t)) == pytest.approx(
        float(v @ _dense_state(t)), abs=1e-12)
    r = tc.Dense1D.rand(4, seed=2, device=CPU)
    assert abs(_c(r.H @ r) - 1) <= TOL
    so = tc.SuperOperator1D.rand(3, 2, seed=1, device=CPU, dtype="float64")
    op = tc.MatrixProductOperator.from_fill_fn(
        lambda s: torch.ones(s, dtype=torch.float64), 3, 2)
    jso = jc.SuperOperator1D([_n(x.data) for x in so], )
    jop = jc.MatrixProductOperator([_n(x.data) for x in op])
    got = tc.superop_TN_1D(so, op)
    want = jc.superop_TN_1D(jso, jop)
    assert set(got.outer_inds()) == set(want.outer_inds())
    assert np.allclose(
        _n(got.contract(..., output_inds=sorted(got.outer_inds()))),
        _n(want.contract(..., output_inds=sorted(want.outer_inds()))),
        atol=1e-12)
    with pytest.raises(NotImplementedError, match="item 16"):
        tc.TNLinearOperator1D(t, ("k0",), ("b0",))
    with pytest.raises(NotImplementedError, match="item 16"):
        t.partial_trace_linop((0,))


def test_environments_flatten_swap():
    j, t = _pair(L=6, chi=4, seed=31)
    norm = t.make_norm()
    envs_l = norm.compute_left_environments()
    envs_r = norm.compute_right_environments()
    assert sorted(envs_l) == list(range(1, 6))
    assert sorted(envs_r) == list(range(0, 5))
    n = _c(t.H @ t)
    for i in range(1, 5):
        mid = norm.select(t.site_tag(i))
        full = tcore.TensorNetwork((envs_l[i], mid, envs_r[i]))
        assert abs(_c(full.contract(...)) - n) <= TOL
    flat = norm.flatten()
    assert flat.num_tensors == 6
    S = tc._swap_gate(2, torch.float64, CPU)
    assert np.allclose(_n(S), _n(jc._swap_gate(2, "float64")))
    x = torch.ones((2, 3))
    assert torch.equal(tc.ar_multiply_axis(x, torch.tensor([1., 2.]), 0),
                       torch.tensor([[1.] * 3, [2.] * 3]))


def test_mps_helpers():
    rng = np.random.default_rng(32)
    j, t = _pair(L=6, chi=4, seed=33)
    v = _dense_state(t)
    full = _n(t.bipartite_schmidt_state(3, get="matrix"))
    assert np.allclose(full.reshape(-1), v, atol=1e-12)
    rho = _n(t.bipartite_schmidt_state(2, get="rho"))
    assert np.allclose(rho, np.outer(v, v), atol=1e-12)
    sw = t.swap_sites_with_compress(1, 4, cutoff=0.0)
    perm = np.moveaxis(v.reshape((2,) * 6), (1, 4), (4, 1)).reshape(-1)
    assert np.allclose(_dense_state(sw), perm, atol=1e-12)
    assert t.permute_arrays() is t
    want = _n(j.partial_trace((1, 2)))
    assert _close(t.partial_trace_to_dense_canonical((1, 2)), want)
    pm = t.partial_trace_to_mpo((1, 2))
    got = _n(pm.to_dense((pm.upper_ind(0), pm.upper_ind(1)),
                         (pm.lower_ind(0), pm.lower_ind(1))))
    assert np.allclose(got, want, atol=1e-12)
    G = rng.normal(size=(4, 4))
    G = torch.as_tensor(G + G.T)
    assert _c(t.local_expectation_canonical(G, (2, 3))) == pytest.approx(
        _c(j.local_expectation_canonical(_n(G), (2, 3))), abs=1e-12)
    with pytest.raises(NotImplementedError, match="item 16"):
        t.logneg_subsys((0,), (1,))
    cyc = tc.MatrixProductState.from_fill_fn(
        lambda s: torch.ones(s, dtype=torch.float64), 4, 2, cyclic=True)
    assert cyc.cyclic
    e = t.copy()
    e.ensure_bonds_exist()
    assert not e.as_cyclic().L != 6


@functools.lru_cache(maxsize=None)
def _gate_with_mpo_pair():
    j, _ = _pair(L=6, chi=4, seed=34)
    jH, _ = _mpo_pair(6)
    return j, jH


@functools.lru_cache(maxsize=None)
def _gate_with_mpo_reference(method, max_bond):
    """quimb_tpu's product of the MPO and the MPS by ``method``."""
    j, jH = _gate_with_mpo_pair()
    return _dense_state(j.gate_with_mpo(jH, max_bond=max_bond, cutoff=0.0,
                                        method=method))


@pytest.mark.parametrize("method,max_bond", [
    ("direct", 5), ("zipup-oversample", 5), ("zipup", 8), ("dm", 8),
    ("direct", 8)])
def test_gate_with_mpo_methods(method, max_bond):
    """MPO x MPS by each ported method. The exact product needs bond 8:
    at bond 5 'direct' and 'zipup-oversample' truncate as quimb_tpu's do;
    zip-up's SVDs of pseudo-canonical columns lose weight even at bond 8,
    as quimb_tpu's do (1.6e-2 from the exact product here); 'dm' and
    'direct' at bond 8 give the exact product."""
    j, jH = _gate_with_mpo_pair()
    t, tH = from_tpu_mps(j, device=CPU), from_tpu_mpo(jH, device=CPU)
    out = t.gate_with_mpo(tH, max_bond=max_bond, cutoff=0.0, method=method)
    assert max(out.bond_sizes()) <= max_bond
    if max_bond == 8 and method != "zipup":
        want = _n(tH.to_dense()) @ _dense_state(t)
    else:
        want = _gate_with_mpo_reference(method, max_bond)
    assert _phase_close(_dense_state(out), want, 1e-9)
    with pytest.raises(NotImplementedError, match="item 16"):
        t.gate_with_mpo(tH, max_bond=5, method="fit")


def test_tensor_network_1d_compress_direct():
    j, t = _pair(L=6, chi=4, seed=35)
    jH, tH = _mpo_pair(6)
    tn = tcomp._lazy_mpo_mps_tn(tH, t)
    out = tcomp.tensor_network_1d_compress(
        tn, max_bond=20, cutoff=0.0, method="direct",
        site_tags=t.site_tags,
        site_inds=[tH.upper_ind(i) for i in range(6)])
    want = _n(tH.to_dense()) @ _dense_state(t)
    got = out.contract(..., output_inds=[tH.upper_ind(i) for i in range(6)])
    assert np.allclose(_n(got).reshape(-1), want, atol=1e-12)
