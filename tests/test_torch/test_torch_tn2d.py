"""quimb_torch's 2D tensor networks (``tensor/tn2d/core.py``,
``builders.py``, ``compress.py``) against quimb_tpu's, in float64 on the
CPU.

A PEPS crosses from quimb_tpu with ``convert.from_tpu_peps`` (the same
arrays, index names and tags). quimb_tpu's side runs on host numpy
arrays inside its ``contract_backend("numpy")`` (its own route for small
boundary bonds), so no test waits on XLA compiles. Boundary contractions
and environments are also held to a dense contraction of the same
network where the boundary bond is large enough to be exact. Tolerances:
1e-10 relative for float64 boundary sweeps of a few hundred QR / SVD
steps, unless a test says otherwise.
"""

import itertools
import re

import numpy as np
import pytest
import torch

import quimb_tpu.tensor as jtn
import quimb_torch.tensor as ttn
from quimb_torch import convert
from quimb_torch.tensor.tn2d import core as tc
from quimb_tpu.ops.contraction import contract_backend as jbackend

CPU = "cpu"
TOL = 1e-10
MODES = ("mps", "projector2d", "dm", "zipup", "direct")
SEQUENCES = (("xmin", "xmax"), ("ymin", "ymax"), ("xmin", "ymin"),
             ("xmax", "ymax", "xmin", "ymin"))


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the boundary sweeps are hundreds of tiny QRs,
    which threads only slow down on a shared host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(Lx, Ly, D, seed=0, phys=2):
    """``PEPS_rand``'s shapes, drawn from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal(
        [D] * sum((i < Lx - 1, j < Ly - 1, i > 0, j > 0)) + [phys])
        for j in range(Ly)] for i in range(Lx)]


def _pair(Lx=3, Ly=3, D=2, seed=0):
    """quimb_tpu's PEPS of the seeded arrays and the port's copy of it."""
    j = jtn.PEPS(_arrays(Lx, Ly, D, seed), shape="urdlp")
    return j, convert.from_tpu_peps(j, device=CPU)


def _host(tn):
    """quimb_tpu's network ``tn`` with host numpy arrays."""
    tn = tn.copy()
    tn.apply_to_arrays(np.asarray)
    return tn


def _n(x):
    x = getattr(x, "data", x)
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().numpy()
    return np.asarray(x)


def _c(x):
    return complex(_n(x).reshape(()))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def _dense_state(arrays):
    """The PEPS of ``arrays`` ('urdlp') as a dense vector, contracted in
    numpy with its own index names (independent of both packages)."""
    Lx, Ly = len(arrays), len(arrays[0])
    operands = []
    sym = itertools.count()
    names = {}

    def bond(a, b):
        key = tuple(sorted((a, b)))
        if key not in names:
            names[key] = next(sym)
        return names[key]

    phys = []
    for i in range(Lx):
        for j in range(Ly):
            inds = []
            if i < Lx - 1:
                inds.append(bond((i, j), (i + 1, j)))
            if j < Ly - 1:
                inds.append(bond((i, j), (i, j + 1)))
            if i > 0:
                inds.append(bond((i, j), (i - 1, j)))
            if j > 0:
                inds.append(bond((i, j), (i, j - 1)))
            p = next(sym)
            phys.append(p)
            operands += [arrays[i][j], inds + [p]]
    return np.einsum(*operands, phys, optimize="greedy").reshape(-1)


def _dense_ham(Lx, Ly, terms):
    """The dense Hamiltonian of ``{((i, j), (k, l)): h}``, sites row-major."""
    n = Lx * Ly
    H = np.zeros((2 ** n, 2 ** n), dtype=complex)
    for (a, b), h in terms.items():
        qa, qb = a[0] * Ly + a[1], b[0] * Ly + b[1]
        h = np.asarray(h).reshape(2, 2, 2, 2)
        op = np.einsum(h, [0, 1, 2, 3], np.eye(2 ** (n - 2)).reshape(
            [2] * (2 * n - 4)), list(range(4, 2 * n)))
        # axes: out_a, out_b, in_a, in_b, then the others' (out..., in...)
        others = [q for q in range(n) if q not in (qa, qb)]
        out_order = [None] * n
        in_order = [None] * n
        out_order[qa], out_order[qb] = 0, 1
        in_order[qa], in_order[qb] = 2, 3
        for k, q in enumerate(others):
            out_order[q] = 4 + k
            in_order[q] = 4 + len(others) + k
        H += np.transpose(op, out_order + in_order).reshape(H.shape)
    return H


def test_peps_structure_matches():
    """The carried PEPS and one the port builds from the same arrays have
    quimb_tpu's shape, tags, site indices and bond layout."""
    j, t = _pair(3, 4, 2)
    built = ttn.PEPS([[torch.as_tensor(a) for a in row]
                      for row in _arrays(3, 4, 2)])
    for tn in (t, built):
        assert isinstance(tn, ttn.PEPS)
        assert (tn.Lx, tn.Ly, tn.nsites) == (j.Lx, j.Ly, j.nsites)
        assert tn.site_tags == j.site_tags
        assert tn.site_inds == j.site_inds
        assert tn.x_tags == j.x_tags and tn.y_tags == j.y_tags
        assert tn.max_bond() == j.max_bond() == 2
        assert tn.phys_dim() == 2
        assert not tn.is_cyclic_x() and not tn.is_cyclic_y()
        for coo in tn.gen_site_coos():
            tt, jt = tn[tn.site_tag(*coo)], j[j.site_tag(*coo)]
            assert tt.shape == jt.shape
            assert set(tt.tags) == set(jt.tags)
    assert set(t.ind_map) == set(j.ind_map)
    assert list(t.gen_bond_coos()) == list(j.gen_bond_coos())
    for name in ("gen_horizontal_bond_coos", "gen_vertical_even_bond_coos",
                 "gen_diagonal_bond_coos", "gen_horizontal_odd_bond_coos"):
        assert list(getattr(t, name)()) == list(getattr(j, name)())
    assert list(t.gen_pairs()) == list(j.gen_pairs())
    assert t.get_ranges_present() == j.get_ranges_present()
    assert t.valid_coo((2, 3)) and not t.valid_coo((3, 0))
    assert t.maybe_convert_coo((1, 2)) == "I1,2"
    r, rj = tc.Rotator2D(t, None, None, "ymax"), jtn.Rotator2D(
        j, None, None, "ymax")
    assert (list(r.sweep), list(r.sweep_other), r.istep) == (
        list(rj.sweep), list(rj.sweep_other), rj.istep)


def test_dense_state_matches():
    """``to_dense`` of the carried PEPS equals quimb_tpu's and the numpy
    contraction of the arrays (1e-12 relative)."""
    j, t = _pair(2, 3, 2, seed=4)
    want = _dense_state(_arrays(2, 3, 2, seed=4))
    got = _n(t.to_dense()).reshape(-1)
    assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want)
    assert np.linalg.norm(got - _n(j.to_dense()).reshape(-1)) <= \
        1e-12 * np.linalg.norm(want)


@pytest.mark.parametrize("sequence", SEQUENCES)
@pytest.mark.parametrize("mode", MODES)
def test_norm2_matches(mode, sequence):
    """``norm2`` by every ported boundary mode and sequence, at a boundary
    bond that keeps it exact: equal to quimb_tpu's and to the dense
    norm."""
    arrays = _arrays(3, 3, 2, seed=1)
    j, t = _pair(3, 3, 2, seed=1)
    want = float(np.sum(_dense_state(arrays) ** 2))
    got = _c(t.norm2(max_bond=64, mode=mode, sequence=sequence))
    with jbackend("numpy"):
        ref = _c(_host(j).norm2(max_bond=64, mode=mode, sequence=sequence))
    assert _rel(got, want) < TOL
    assert _rel(got, ref) < TOL


@pytest.mark.parametrize("mode", MODES)
def test_truncated_boundary_matches(mode):
    """A boundary contraction that truncates (boundary bond 3 on a D=2
    norm network of 4 x 3 sites) gives quimb_tpu's value: the same steps
    in the same order."""
    j, t = _pair(4, 3, 2, seed=2)
    got = _c(t.make_norm().contract_boundary(max_bond=3, mode=mode))
    with jbackend("numpy"):
        ref = _c(_host(j).make_norm().contract_boundary(max_bond=3,
                                                        mode=mode))
    exact = float(np.sum(_dense_state(_arrays(4, 3, 2, seed=2)) ** 2))
    assert _rel(got, ref) < TOL
    # the truncation really cut something
    assert _rel(got, exact) > 1e-8


@pytest.mark.parametrize("from_which", ["xmin", "xmax", "ymin", "ymax"])
def test_contract_boundary_from_matches(from_which):
    """``contract_boundary_from`` over part of the lattice leaves the same
    network as quimb_tpu's (same tensor count, same contracted value)."""
    j, t = _pair(3, 3, 2, seed=3)
    xr, yr = ((0, 1), None) if from_which[0] == "x" else (None, (0, 1))
    tn = t.make_norm().contract_boundary_from(from_which, max_bond=8,
                                              xrange=xr, yrange=yr)
    with jbackend("numpy"):
        jn = _host(j).make_norm().contract_boundary_from(
            from_which, max_bond=8, xrange=xr, yrange=yr)
        ref = _c(jn.contract(...))
    assert tn.num_tensors == jn.num_tensors
    assert _rel(_c(tn.contract(...)), ref) < TOL


@pytest.mark.parametrize("direction", ["x", "y"])
def test_environments_match(direction):
    """Each row's (column's) environments with the row itself contract to
    the norm, as quimb_tpu's do, and the environments' own values match
    quimb_tpu's."""
    j, t = _pair(3, 3, 2, seed=5)
    norm = t.make_norm()
    envs = getattr(norm, f"compute_{direction}_environments")(max_bond=16)
    with jbackend("numpy"):
        jnorm = _host(j).make_norm()
        jenvs = getattr(jnorm, f"compute_{direction}_environments")(
            max_bond=16)
        assert set(envs) == set(jenvs)
        exact = float(np.sum(_dense_state(_arrays(3, 3, 2, seed=5)) ** 2))
        lo, hi = f"{direction}min", f"{direction}max"
        tag = norm.x_tag if direction == "x" else norm.y_tag
        for i in range(3):
            parts = [envs[lo, i], norm.select(tag(i), which="any"),
                     envs[hi, i]]
            tn = ttn.TensorNetwork([])
            for p in parts:
                if p.num_tensors:
                    tn.add_tensor_network(p.copy(), virtual=True,
                                          check_collisions=False)
            assert _rel(_c(tn.contract(...)), exact) < TOL
            for k in (lo, hi):
                if envs[k, i].num_tensors:
                    e = envs[k, i].copy()
                    e.exponent = 0.0
                    je = jenvs[k, i].copy()
                    je.exponent = 0.0
                    assert abs(envs[k, i].exponent - jenvs[k, i].exponent) \
                        < 1e-10
                    assert e.num_tensors == je.num_tensors
                    for ta, tb in zip(e.tensor_map.values(),
                                      je.tensor_map.values()):
                        assert ta.shape == tb.shape


def _close_plaquette(norm, env, x0, y0, bsz):
    """``env`` with the plaquette's own tensors of ``norm``, contracted."""
    plq = env.copy()
    for dx, dy in itertools.product(range(bsz[0]), range(bsz[1])):
        for tt in norm.select(norm.site_tag(x0 + dx, y0 + dy),
                              which="any"):
            plq.add_tensor(tt.copy(), virtual=True)
    return _c(plq.contract(...))


def test_plaquette_environments_match():
    """Every 2 x 1 and 1 x 2 plaquette environment, closed with its
    plaquette's tensors, contracts to quimb_tpu's value (the environments'
    scale factors ride ``exponent`` in both packages alike), and every
    plaquette of one shape to one value up to that scale."""
    j, t = _pair(3, 3, 2, seed=6)
    norm = t.make_norm()
    with jbackend("numpy"):
        jnorm = _host(j).make_norm()
        for bsz in ((1, 2), (2, 1)):
            envs = norm.compute_plaquette_environments(*bsz, max_bond=16)
            jenvs = jnorm.compute_plaquette_environments(*bsz, max_bond=16)
            assert set(envs) == set(jenvs)
            for key, env in envs.items():
                (x0, y0), _ = key
                got = _close_plaquette(norm, env, x0, y0, bsz)
                ref = _close_plaquette(jnorm, jenvs[key], x0, y0, bsz)
                assert _rel(got, ref) < TOL


@pytest.mark.parametrize("where,contract", [
    (((1, 1),), True), (((1, 1),), False),
    *[(w, c) for w in (((0, 1), (1, 1)), ((1, 0), (1, 1)))
      for c in (True, "reduce-split", False, "split")],
])
def test_gate_matches(where, contract):
    """``gate`` of a random one- or two-site operator: the dense state
    equals quimb_tpu's and the dense operator applied to the dense state
    (1e-12 relative)."""
    rng = np.random.default_rng(7)
    j, t = _pair(2, 3, 2, seed=8)
    d = 2 ** len(where)
    G = rng.standard_normal((d, d))
    got = _n(t.gate(G, where if len(where) > 1 else where[0],
                    contract=contract).to_dense()).reshape(-1)
    ref = _n(j.gate(G, where if len(where) > 1 else where[0],
                    contract=contract).to_dense()).reshape(-1)
    psi = _dense_state(_arrays(2, 3, 2, seed=8)).reshape([2] * 6)
    qs = [a * 3 + b for a, b in where]
    want = np.tensordot(G.reshape([2] * (2 * len(qs))), psi,
                        axes=(list(range(len(qs), 2 * len(qs))), qs))
    want = np.moveaxis(want, list(range(len(qs))), qs).reshape(-1)
    assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want)
    assert np.linalg.norm(got - ref) <= 1e-12 * np.linalg.norm(want)


@pytest.mark.parametrize("normalized", [True, False])
def test_compute_local_expectation_matches(normalized):
    """The Heisenberg energy by ``compute_local_expectation`` at a boundary
    bond that keeps it exact: equal to quimb_tpu's and to the dense
    expectation; each term's (value, norm) pair too."""
    arrays = _arrays(2, 3, 2, seed=9)
    j, t = _pair(2, 3, 2, seed=9)
    ham = ttn.ham_2d_heis(2, 3)
    got = t.compute_local_expectation(ham.terms, max_bond=64,
                                      normalized=normalized)
    ref = j.compute_local_expectation(jtn.ham_2d_heis(2, 3).terms,
                                      max_bond=64, normalized=normalized)
    v = _dense_state(arrays)
    want = (v @ _dense_ham(2, 3, ham.terms) @ v).real
    if normalized:
        want /= v @ v
    assert _rel(got, ref) < TOL
    if normalized:
        assert _rel(got, want) < TOL
    allt = t.compute_local_expectation(ham.terms, max_bond=64,
                                       return_all=True)
    allj = j.compute_local_expectation(jtn.ham_2d_heis(2, 3).terms,
                                       max_bond=64, return_all=True)
    assert set(allt) == set(allj)
    for k, (val, nrm) in allt.items():
        assert _rel(val / nrm, allj[k][0] / allj[k][1]) < TOL


def test_truncated_expectation_matches():
    """At a boundary bond that truncates (2 on a 4 x 4 D=2 state) the
    energy is still quimb_tpu's."""
    j, t = _pair(4, 4, 2, seed=10)
    got = t.compute_local_expectation(ttn.ham_2d_heis(4, 4).terms,
                                      max_bond=2)
    ref = j.compute_local_expectation(jtn.ham_2d_heis(4, 4).terms,
                                      max_bond=2)
    assert _rel(got, ref) < TOL


def test_expectation_on_host_arrays():
    """Inside ``contract_backend("numpy")`` a PEPS of host arrays keeps
    them and contracts on the host, to the value of its torch copy and of
    quimb_tpu (truncating at boundary bond 4)."""
    arrays = _arrays(3, 3, 2, seed=13)
    ham = ttn.ham_2d_heis(3, 3)
    want = ttn.PEPS([[torch.as_tensor(a) for a in row] for row in arrays]
                    ).compute_local_expectation(ham.terms, max_bond=4)
    ref = jtn.PEPS(arrays).compute_local_expectation(
        jtn.ham_2d_heis(3, 3).terms, max_bond=4)
    with ttn.contract_backend("numpy"):
        psi = ttn.PEPS(arrays)
        got = psi.compute_local_expectation(ham.terms, max_bond=4)
        assert all(isinstance(t.data, np.ndarray) for t in psi)
    assert _rel(got, want) < TOL and _rel(got, ref) < TOL


def test_normalize_matches():
    j, t = _pair(3, 3, 2, seed=11)
    t.normalize(max_bond=64)
    j.normalize(max_bond=64)
    assert _rel(_c(t.norm2(max_bond=64)), 1.0) < TOL
    tt, jt = t[t.site_tag(0, 0)], j[j.site_tag(0, 0)]
    assert np.allclose(_n(tt), np.asarray(jt.data), rtol=1e-10)


def test_wired_row_methods_match():
    """``canonize_row`` keeps the state; ``compress_row`` to bond 1 gives
    quimb_tpu's state; ``flatten`` of the norm network leaves one tensor a
    site with its value."""
    j, t = _pair(3, 3, 2, seed=12)
    v0 = _n(t.to_dense()).reshape(-1)
    t.canonize_row(1)
    j.canonize_row(1)
    assert np.linalg.norm(_n(t.to_dense()).reshape(-1) - v0) <= \
        1e-12 * np.linalg.norm(v0)
    t.compress_column(2, max_bond=1, cutoff=0.0)
    j.compress_column(2, max_bond=1, cutoff=0.0)
    got, ref = _n(t.to_dense()).reshape(-1), _n(j.to_dense()).reshape(-1)
    assert abs(abs(got @ ref) / (np.linalg.norm(got) * np.linalg.norm(ref))
               - 1) < 1e-10
    norm = t.make_norm()
    flat = norm.flatten()
    assert flat.num_tensors == 9
    assert _rel(_c(flat.contract(...)), _c(norm.contract(...))) < TOL


def test_pepo_matches():
    """A random PEPO carried across, the identity PEPO and a product
    operator: the dense operators equal quimb_tpu's (or numpy's)."""
    jp = jtn.PEPO_rand(2, 2, 2, seed=3)
    tp = convert.from_tpu_pepo(jp, device=CPU)
    assert isinstance(tp, ttn.PEPO)
    assert np.allclose(_n(tp.to_dense()), np.asarray(jp.to_dense()),
                       rtol=1e-12, atol=1e-12)
    ident = ttn.PEPO_identity(2, 3, device=CPU)
    assert np.allclose(_n(ident.to_dense()), np.eye(64))
    ops = [[np.array([[0, 1], [1, 0]]), np.diag([1.0, -1.0])],
           [np.eye(2), np.array([[1.0, 2.0], [3.0, 4.0]])]]
    po = ttn.PEPO_product_operator(ops, device=CPU)
    # a site array's axes are (lower, upper): the dense rows, indexed by
    # the upper indices, hold the transposes
    want = np.kron(np.kron(ops[0][0].T, ops[0][1].T),
                   np.kron(ops[1][0].T, ops[1][1].T))
    assert np.allclose(_n(po.to_dense()), want)
    assert np.allclose(want, np.asarray(
        jtn.PEPO_product_operator(ops).to_dense()))
    z = tc.PEPO.zeros(2, 2, 3, device=CPU)
    assert z.max_bond() == 3 and float(_n(z.to_dense()).sum()) == 0.0
    r = tc.PEPO.rand_herm(2, 2, 2, seed=1, device=CPU)
    dense = _n(r.to_dense())
    assert np.allclose(dense, dense.conj().T)


def test_peps_builders():
    """The product-state builders give numpy's kron; the random builder is
    seeded and has PEPS_rand's shapes; zeros and ones fill."""
    bits = "011010"
    psi = ttn.PEPS_computational_state(bits, Lx=2, Ly=3, device=CPU)
    want = np.zeros(64)
    want[int(bits, 2)] = 1.0
    assert np.allclose(_n(psi.to_dense()).reshape(-1), want)
    vecs = [[np.array([1.0, 2.0]), np.array([0.5, -1.0])]]
    ps = ttn.PEPS_product_state(vecs, device=CPU)
    assert np.allclose(_n(ps.to_dense()).reshape(-1),
                       np.kron(vecs[0][0], vecs[0][1]))
    a = ttn.PEPS_rand(3, 3, 2, seed=5, device=CPU)
    b = ttn.PEPS_rand(3, 3, 2, seed=5, device=CPU)
    j = jtn.PEPS_rand(3, 3, 2, seed=5)
    for coo in a.gen_site_coos():
        ta, tb = a[a.site_tag(*coo)], b[b.site_tag(*coo)]
        assert ta.shape == j[j.site_tag(*coo)].shape
        assert torch.equal(ta.data, tb.data)
    assert float(_n(ttn.PEPS_zeros(2, 2, 2, device=CPU).to_dense()).sum()) \
        == 0.0
    ones = tc.PEPS.ones(2, 2, 2, device=CPU)
    assert all(bool((t.data == 1).all()) for t in ones)


def test_gauges_cross():
    """``convert.from_tpu_gauges`` keeps the keys and values."""
    g = {((0, 0), (0, 1)): np.array([0.9, 0.1])}
    out = convert.from_tpu_gauges(g, device=CPU)
    assert list(out) == list(g)
    assert torch.equal(out[(0, 0), (0, 1)], torch.tensor([0.9, 0.1],
                                                         dtype=torch.float64))


def _value(x):
    """A host array of a call's result: a network contracted, a tensor's
    data with its indices sorted, or a scalar; a FullUpdate's energy."""
    if hasattr(x, "compute_energy"):
        return np.asarray(np.real(complex(x.compute_energy())))
    if hasattr(x, "tensor_map"):
        x = x.contract(...)
    if hasattr(x, "inds"):
        x = x.transpose(*sorted(x.inds)).data
    return _n(x)


def _full_update(t):
    """FullUpdate of the 2 x 2 Heisenberg model in ``t``'s package."""
    m = jtn if isinstance(t, jtn.PEPS) else ttn
    return m.FullUpdate(t, m.ham_2d_heis(2, 2))


def _compress_2d(t, method="local-early"):
    """``tensor_network_2d_compress`` of ``t`` to bond 1 in its package."""
    m = jtn if isinstance(t, jtn.PEPS) else ttn
    return m.tensor_network_2d_compress(t, max_bond=1, method=method)


@pytest.mark.parametrize("call,item", [
    (lambda t: t.contract_hotrg(), "13(b)"),
    (lambda t: t.contract_ctmrg(), "13(b)"),
    (lambda t: t.coarse_grain_hotrg("x"), "13(b)"),
    (lambda t: t.make_norm().contract_boundary(max_bond=4,
                                               mode="full-bond"), "13(b)"),
    (lambda t: t.add_PEPS(t), "16"),
    (lambda t: _compress_2d(t), "16"),
    (lambda t: _full_update(t), "13(b)"),
])
def test_left_out_parts_name_their_item(call, item):
    """The parts once left out for ROADMAP items 13(b) and 16 are ported
    (item 16's direct sum and 2D compression with its part 16(a)) and
    give quimb_tpu's values (its side on host arrays)."""
    j, t = _pair(2, 2, 2)
    with jbackend("numpy"):
        want = _value(call(_host(j)))
    np.testing.assert_allclose(_value(call(t)), want, rtol=TOL, atol=1e-12)


@pytest.mark.parametrize("build", [
    lambda: ttn.PEPS_rand(2, 2, 2),
    lambda: ttn.PEPS_computational_state("0000", Lx=2, Ly=2),
    lambda: ttn.PEPO_identity(2, 2),
    lambda: convert.from_tpu_peps(jtn.PEPS_rand(2, 2, 2)),
    lambda: ttn.TN_from_edges_rand(ttn.edges_2d_square(2, 2), 2, phys_dim=2),
    lambda: convert.from_tpu_tngen(jtn.TN_from_edges_and_fill_fn(
        np.ones, jtn.edges_2d_square(2, 2), 2, phys_dim=2)),
    lambda: ttn.PEPS3D.rand(2, 1, 2, 2),
    lambda: ttn.PEPS3D.from_fill_fn(np.ones, 1, 2, 2, 2),
    lambda: convert.from_tpu_tn3d(jtn.PEPS3D.from_fill_fn(
        np.ones, 1, 2, 2, 2)),
    lambda: ttn.TN3D_classical_ising_partition_function(2, 2, 2, beta=0.3),
    lambda: ttn.HTN3D_classical_ising_partition_function(2, 2, 2, beta=0.3,
                                                         h=0.1),
    lambda: ttn.TN2D_rand(2, 2, 2, seed=1),
    lambda: ttn.TN2D_empty(2, 2, 2),
    lambda: ttn.TN3D_with_value(1.0, 2, 2, 1, 2),
    lambda: ttn.TN2D_corner_double_line(2, 2),
    lambda: ttn.HTN_random_ksat(3, 5, alpha=2.0, seed=1),
    lambda: ttn.TN_from_sites_computational_state({0: "0", 1: "+"}),
    lambda: ttn.TN2D_embedded_classical_ising_partition_function(
        np.tril(np.ones((3, 3)), -1), 0.3),
])
def test_entry_points_default_to_the_gpu(build):
    """With no ``device``, a 2D builder puts its tensors on the GPU; with no
    GPU the call raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        assert all(t.data.is_cuda for t in build())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
