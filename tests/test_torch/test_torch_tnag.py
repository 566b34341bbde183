"""quimb_torch's arbitrary-geometry layer (``tensor/tnag/core.py``,
``builders.py``) against quimb_tpu's, in float64 on the CPU.

A network is built in quimb_tpu from a numpy fill function and carried
across by ``convert.from_tpu_tngen``, so both packages hold the same
arrays, index names and tags; the port's own builders are held to the same
values from the same fill. Results are compared as dense vectors or
scalars: a few hundred flops of O(1) numbers, so 1e-12 unless a test says
otherwise; a split or a gauge converged to 1e-9 agrees to 1e-10.
"""

import itertools
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import quimb_tpu.tensor as jtn
import quimb_torch.tensor as ttn
from quimb_torch import convert
from quimb_tpu.ops.contraction import contract_backend as jbackend

CPU = "cpu"
TOL = 1e-12
EDGES = ttn.edges_2d_square(2, 3)


@pytest.fixture(autouse=True)
def _one_thread_host_reference():
    """One torch thread (small splits, which threads only slow down on a
    shared host), and quimb_tpu on host numpy arrays (its
    ``contract_backend("numpy")``: no XLA dispatch of tiny operations)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with jbackend("numpy"):
        yield
    torch.set_num_threads(n)


def _fill(seed, cplx=False):
    rng = np.random.default_rng(seed)

    def fill(shape):
        x = rng.normal(size=shape)
        return x + 1j * rng.normal(size=shape) if cplx else x
    return fill


def _pair(edges=EDGES, D=2, seed=0, phys_dim=2, cplx=False, **kw):
    """quimb_tpu's network of the seeded fill and the port's copy."""
    j = jtn.TN_from_edges_and_fill_fn(_fill(seed, cplx), edges, D,
                                      phys_dim=phys_dim, **kw)
    return j, convert.from_tpu_tngen(j, device=CPU)


def _n(x):
    x = getattr(x, "data", x)
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().numpy()
    return np.asarray(x)


def _dense(tn):
    return _n(tn.to_dense())


def _herm(d=4, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    return (X + X.conj().T).real


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_n(a), _n(b), rtol=0, atol=tol)


# -- builders and structure ---------------------------------------------------


@pytest.mark.parametrize("phys_dim,kind", [
    (2, "TensorNetworkGenVector"), (None, "TensorNetworkGen")])
def test_builder_matches(phys_dim, kind):
    j, t = _pair(phys_dim=phys_dim)
    own = ttn.TN_from_edges_and_fill_fn(_fill(0), EDGES, 2,
                                        phys_dim=phys_dim, device=CPU)
    for tn in (t, own):
        assert type(tn).__name__ == kind
        assert tn.sites == j.sites and tn.site_tag_id == j.site_tag_id
        assert all(x.data.device.type == "cpu" for x in tn)
    if phys_dim is None:
        want = complex(j.contract(...))
        for tn in (t, own):
            assert complex(tn.contract(...)) == pytest.approx(want, abs=1e-10)
        return
    _close(_dense(t), _dense(j))
    _close(_dense(own), _dense(j))
    assert t.site_inds == j.site_inds and t.phys_dim() == j.phys_dim()


def test_operator_builder_and_to_dense():
    ids = ("k{}", "b{}")
    j, t = _pair(site_ind_id=ids, seed=1)
    own = ttn.TN_from_edges_and_fill_fn(_fill(1), EDGES, 2, phys_dim=2,
                                        site_ind_id=ids, device=CPU)
    assert type(t).__name__ == type(own).__name__ == \
        "TensorNetworkGenOperator"
    assert (t.upper_ind_id, t.lower_ind_id) == ids
    _close(_dense(t), _dense(j), 1e-10)
    _close(_dense(own), _dense(j), 1e-10)
    assert _dense(t).shape == (2**6, 2**6)
    _close(_n(t.partial_transpose((0, 0)).to_dense()),
           _n(j.partial_transpose((0, 0)).to_dense()), 1e-10)
    assert t.phys_dim() == 2


def test_structure_helpers_match():
    j, t = _pair(edges=ttn.edges_2d_kagome(1, 2))
    assert list(t.gen_bonds()) == list(j.gen_bonds())
    assert t.get_site_neighbor_map() == j.get_site_neighbor_map()
    s = t.sites[1]
    assert t.neighbors(s) == j.neighbors(s)
    assert t._site_neighborhood([s], 2) == j._site_neighborhood([s], 2)
    assert t.site_tags == j.site_tags
    assert t.filter_valid_site_tags(["I(0, 0, 'A')", "x"]) == \
        j.filter_valid_site_tags(["I(0, 0, 'A')", "x"])
    assert t.select_sites(t.sites[:2]).num_tensors == 2
    r = t.retag_all("S{}")
    assert r.site_tag_id == "S{}" and r.site_tag(s) in r.tag_map
    ri = t.reindex_all("q{}")
    assert ri.site_ind_id == "q{}" and ri.site_ind(s) in ri.ind_map
    assert t.gen_site_coos() == j.gen_site_coos()
    assert t.has_site(s) and not t.has_site("nowhere")
    edges, nbrs = ttn.create_lazy_edge_map(t)
    edges_j, nbrs_j = jtn.create_lazy_edge_map(j)
    assert edges == edges_j and nbrs == nbrs_j


def test_edge_coloring_matches():
    edges = ttn.edges_2d_kagome(2, 2)
    got = ttn.edge_coloring(edges)
    assert got == jtn.edge_coloring(edges)
    for color in got:
        sites = [s for e in color for s in e]
        assert len(sites) == len(set(sites))


def test_rand_builders():
    """``TN_from_edges_rand`` draws from a torch generator, seeded site by
    site: the same seed gives the same network; ``normalize`` makes it a
    unit vector; ``TN_rand_reg`` and ``TN_from_edges_empty`` build their
    graphs' structures."""
    a = ttn.TN_from_edges_rand(EDGES, 2, phys_dim=2, seed=5, device=CPU)
    b = ttn.TN_from_edges_rand(EDGES, 2, phys_dim=2, seed=5, device=CPU)
    _close(_dense(a), _dense(b), 0.0)
    assert a.dtype == torch.complex128
    u = ttn.TN_from_edges_rand(EDGES, 2, phys_dim=2, seed=5, normalize=True,
                               dtype="float64", device=CPU)
    assert np.linalg.norm(_dense(u)) == pytest.approx(1.0, abs=1e-12)
    r = ttn.TN_rand_reg(8, 3, 2, phys_dim=2, seed=1, dtype="float64",
                        device=CPU)
    rj = jtn.TN_rand_reg(8, 3, 2, phys_dim=2, seed=1, dtype="float64")
    assert r.sites == rj.sites and sorted(
        t.shape for t in r) == sorted(t.shape for t in rj)
    e = ttn.TN_from_edges_empty(EDGES, 3, phys_dim=2, dtype="float64",
                                device=CPU)
    assert all(float(t.data.abs().max()) == 0.0 for t in e)
    assert e.max_bond() == 3


# -- gating and gauging -------------------------------------------------------


@pytest.mark.parametrize("contract", [False, True, "split", "reduce-split",
                                      "split-gate", "auto-split-gate"])
def test_gate_matches(contract):
    j, t = _pair(seed=2)
    G = _herm(4, seed=4)
    where = (j.sites[0], j.sites[1])
    gj = j.gate(G, where, contract=contract)
    gt = t.gate(G, where, contract=contract)
    _close(_dense(gt), _dense(gj), 1e-10)
    assert gt.num_tensors == gj.num_tensors
    g1 = t.gate(G[:2, :2], (where[0],))
    _close(_dense(g1), _dense(j.gate(G[:2, :2], (where[0],))), 1e-10)


def test_gate_simple_matches():
    j, t = _pair(seed=3)
    gj, gt = {}, {}
    jj = j.gauge_all_simple(gauges=gj)
    tt = t.gauge_all_simple(gauges=gt)
    G = _herm(4, seed=5)
    for where in [(j.sites[0], j.sites[1]), (j.sites[1], j.sites[4])]:
        jj.gate_simple_(G, where, gj, max_bond=2)
        tt.gate_simple_(G, where, gt, max_bond=2)
    assert set(gt) == set(gj)
    for ix in gj:
        _close(gt[ix], gj[ix], 1e-10)
    _close(_dense(tt.gauge_simple_insert(gt)),
           _dense(jj.gauge_simple_insert(gj)), 1e-10)


def test_gauge_all_simple_matches():
    j, t = _pair(seed=4)
    gj, gt, ij, it = {}, {}, {}, {}
    j.gauge_all_simple(gauges=gj, info=ij)
    t.gauge_all_simple(gauges=gt, info=it)
    assert set(gt) == set(gj)
    for ix in gj:
        _close(gt[ix], gj[ix], 1e-10)
    assert it["log_scale"] == pytest.approx(ij["log_scale"], abs=1e-10)
    # without gauges given they are reabsorbed, each normalised: the state
    # is kept up to the factor exp(log_scale), as in quimb_tpu
    _close(_dense(t.gauge_all_simple()), _dense(j.gauge_all_simple()), 1e-10)
    _close(_dense(t.gauge_all_simple()) * np.exp(it["log_scale"]),
           _dense(t), 1e-9)
    n = t.copy()
    n.normalize_simple(gt)
    nj = j.copy()
    nj.normalize_simple(gj)
    _close(_dense(n), _dense(nj), 1e-10)


# -- local expectations -------------------------------------------------------


@pytest.mark.parametrize("cplx", [False, True])
def test_local_expectations_match(cplx):
    j, t = _pair(seed=5, cplx=cplx)
    G = _herm(4, seed=6)
    where = (j.sites[0], j.sites[1])
    assert complex(t.local_expectation_exact(G, where)) == pytest.approx(
        complex(j.local_expectation_exact(G, where)), abs=1e-12)
    gj, gt = {}, {}
    j.gauge_all_simple(gauges=gj)
    t.gauge_all_simple(gauges=gt)
    for dist in (1, 2):
        want = complex(j.local_expectation_cluster(G, where, gauges=gj,
                                                   max_distance=dist))
        got = complex(t.local_expectation_cluster(G, where, gauges=gt,
                                                  max_distance=dist))
        assert got == pytest.approx(want, abs=1e-10)
    assert complex(t.local_expectation(G, where, method="exact")) == \
        pytest.approx(complex(j.local_expectation(G, where,
                                                  method="exact")), abs=1e-12)


@pytest.mark.parametrize("method", ["exact", "cluster"])
def test_compute_local_expectation_matches(method):
    edges = ttn.edges_2d_kagome(1, 2)
    j, t = _pair(edges=edges, seed=6)
    hj, ht = jtn.ham_gen_heis(edges), ttn.ham_gen_heis(edges)
    want = j.compute_local_expectation(hj.terms, method=method)
    got = t.compute_local_expectation(ht.terms, method=method)
    assert got == pytest.approx(want, abs=1e-10)
    # the terms submitted to a thread pool give the same values
    with ThreadPoolExecutor(4) as ex:
        par = t.compute_local_expectation(ht.terms, method=method,
                                          executor=ex, return_all=True)
    ser = t.compute_local_expectation(ht.terms, method=method,
                                      return_all=True)
    assert set(par) == set(ser)
    for where in ser:
        assert complex(par[where]) == pytest.approx(complex(ser[where]),
                                                    abs=1e-13)


def test_contraction_cache_shared_by_threads():
    """Many threads contracting structurally equal networks at once, all
    reading and writing the shared expression cache: every value right."""
    j, t = _pair(seed=7)
    want = complex(t.make_norm().contract(..., optimize="auto"))
    nets = [t.make_norm() for _ in range(32)]
    with ThreadPoolExecutor(8) as ex:
        got = list(ex.map(lambda n: complex(n.contract(..., optimize="auto")),
                          nets))
    assert np.allclose(got, want, rtol=1e-13, atol=0)


def test_partial_trace_and_sample_match():
    j, t = _pair(seed=8)
    where = (j.sites[0],)
    _close(t.partial_trace(where, method="exact"),
           j.partial_trace(where, method="exact"), 1e-12)
    gj, gt = {}, {}
    j.gauge_all_simple(gauges=gj)
    t.gauge_all_simple(gauges=gt)
    _close(t.partial_trace(where, method="cluster", gauges=gt),
           j.partial_trace(where, method="cluster", gauges=gj), 1e-10)
    assert t.sample_configuration_cluster(seed=3, gauges=gt)[0] == \
        j.sample_configuration_cluster(seed=3, gauges=gj)[0]


LOOP_EXPANSIONS = [
    (lambda tn, G, w: tn.local_expectation(G, w, method="gloop-expand"),
     lambda tn, G, w: tn.local_expectation_gloop_expand(G, w)),
    (lambda tn, G, w: tn.local_expectation(G, w, method="sloop-expand"),
     lambda tn, G, w: tn.local_expectation_gloop_expand(G, w,
                                                        loops="sloops")),
    (lambda tn, G, w: tn.local_expectation_gloop_expand(G, w, max_size=6),
     lambda tn, G, w: tn.local_expectation_gloop_expand(G, w, max_size=6)),
    (lambda tn, G, w: tn.norm_gloop_expand(),
     lambda tn, G, w: tn.norm_gloop_expand()),
    (lambda tn, G, w: tn.compute_local_expectation_gloop_expand({w: G}),
     lambda tn, G, w: tn.local_expectation_gloop_expand(G, w)),
    (lambda tn, G, w: tn.compute_local_expectation_sloop_expand({w: G}),
     lambda tn, G, w: tn.local_expectation_gloop_expand(G, w,
                                                        loops="sloops")),
]


@pytest.mark.parametrize("call", range(len(LOOP_EXPANSIONS)))
def test_loop_expansions_name_their_item(call):
    """The loop expansions, once deferred to ROADMAP item 16(c) (which
    ported belief propagation's RegionGraph), give quimb_tpu's values.
    quimb_tpu's ``compute_local_expectation_gloop_expand`` passes
    ``method="gloop"``, which its dispatcher reads as the cluster method;
    the port's names the expansion, so those two cases are held to
    quimb_tpu's ``local_expectation_gloop_expand``. Counting numbers are
    integers and each region a small exact contraction: 1e-10."""
    port, ref = LOOP_EXPANSIONS[call]
    j, t = _pair(seed=9)
    where = (t.sites[0], t.sites[1])
    G = _herm(4)
    got, want = port(t, G, where), ref(j, G, where)
    assert complex(got) == pytest.approx(complex(want), rel=1e-10,
                                         abs=1e-12)


# -- combinators -------------------------------------------------------------


@pytest.mark.parametrize("negate", [False, True])
def test_ag_sum_matches(negate):
    ja, ta = _pair(seed=10)
    jb, tb = _pair(seed=11)
    want = _dense(jtn.tensor_network_ag_sum(ja, jb, negate=negate))
    got = ttn.tensor_network_ag_sum(ta, tb, negate=negate)
    _close(_dense(got), want, 1e-10)
    sign = -1 if negate else 1
    _close(_dense(got), _dense(ta) + sign * _dense(tb), 1e-10)
    assert got.max_bond() == 4
    c = ttn.tensor_network_ag_sum(ta, tb, compress=True, max_bond=4,
                                  cutoff=0.0)
    _close(_dense(c), _dense(ta) + _dense(tb), 1e-10)


def test_apply_op_vec_and_op_op_match():
    ids = ("k{}", "b{}")
    jA, tA = _pair(site_ind_id=ids, seed=12)
    jx, tx = _pair(seed=13)
    A = _dense(tA)
    for contract in (False, True):
        got = ttn.tensor_network_apply_op_vec(tA, tx, contract=contract)
        want = jtn.tensor_network_apply_op_vec(jA, jx, contract=contract)
        _close(_dense(got), _dense(want), 1e-9)
        _close(_dense(got), A @ _dense(tx), 1e-9)
    got = tA.apply(tx, compress=True, max_bond=8, cutoff=0.0)
    _close(_dense(got), A @ _dense(tx), 1e-9)
    jB, tB = _pair(site_ind_id=ids, seed=14)
    B = _dense(tB)
    got = ttn.tensor_network_apply_op_op(tA, tB, contract=True)
    want = jtn.tensor_network_apply_op_op(jA, jB, contract=True)
    _close(_dense(got), _dense(want), 1e-8)
    _close(_dense(got), A @ B, 1e-8)


def test_align_matches():
    ids = ("k{}", "b{}")
    jA, tA = _pair(site_ind_id=ids, seed=15)
    jx, tx = _pair(seed=16)
    jy, ty = _pair(seed=17)
    got = ttn.tensor_network_align(tx, tA, ty)
    want = jtn.tensor_network_align(jx, jA, jy)
    for g, w in zip(got, want):
        assert g.outer_inds() == w.outer_inds()
    ev = complex((got[0].conj() & got[1] & got[2]).contract(...))
    evj = complex((want[0].conj() & want[1] & want[2]).contract(...))
    assert ev == pytest.approx(evj, abs=1e-10)


def test_operator_gates_match():
    ids = ("k{}", "b{}")
    jA, tA = _pair(site_ind_id=ids, seed=18)
    G = _herm(4, seed=19)
    where = (jA.sites[0], jA.sites[1])
    for which in ("upper", "lower", "sandwich"):
        got = tA.gate(G, where, which=which, contract=False)
        want = jA.gate(G, where, which=which, contract=False)
        _close(_dense(got), _dense(want), 1e-9)


# -- classical and counting networks ------------------------------------------


def _ising_brute(edges, beta, j, h):
    sites = sorted({s for e in edges for s in e})
    Z = 0.0
    for spins in itertools.product((1, -1), repeat=len(sites)):
        s = dict(zip(sites, spins))
        E = sum(j * s[a] * s[b] for a, b in edges) + h * sum(spins)
        Z += np.exp(beta * E)
    return Z


@pytest.mark.parametrize("builder", [
    "TN_classical_partition_function_from_edges",
    "HTN_classical_partition_function_from_edges"])
def test_partition_functions_match(builder):
    edges = ttn.edges_2d_square(2, 3)
    kw = dict(beta=0.3, j=0.7, h=0.2)
    got = complex(getattr(ttn, builder)(edges, device=CPU, **kw).contract(
        ..., output_inds=()))
    want = complex(getattr(jtn, builder)(edges, **kw).contract(
        ..., output_inds=()))
    assert got == pytest.approx(want, rel=1e-12)
    assert got.real == pytest.approx(_ising_brute(edges, 0.3, 0.7, 0.2),
                                     rel=1e-12)


def test_3d_partition_function_matches():
    kw = dict(beta=0.2, j=1.0, h=0.1)
    got = complex(ttn.TN3D_classical_ising_partition_function(
        2, 2, 2, device=CPU, **kw).contract(..., output_inds=()))
    want = complex(jtn.tnag.TN3D_classical_ising_partition_function(
        2, 2, 2, **kw).contract(..., output_inds=()))
    assert got == pytest.approx(want, rel=1e-12)


CNF = """c a small instance
p cnf 4 4
1 -2 3 0
-1 2 0
2 3 -4 0
4 1 0
"""


def _count_sat(clauses, n, weights=None):
    tot = 0.0
    for bits in itertools.product((0, 1), repeat=n):
        ok = all(any((bits[abs(v) - 1] == 1) == (v > 0) for v in c)
                 for c in clauses)
        if ok:
            w = 1.0
            for v, wv in (weights or {}).items():
                w *= wv[bits[v - 1]] if isinstance(wv, tuple) else (
                    wv if bits[v - 1] else 1.0)
            tot += w
    return tot


@pytest.mark.parametrize("mode", ["dense", "parafac", "mps", 2])
def test_clause_networks_count_assignments(mode):
    inst = ttn.cnf_file_parse(CNF)
    assert inst == jtn.cnf_file_parse(CNF)
    assert inst["num_variables"] == 4 and inst["num_clauses"] == 4
    weights = {1: 0.5, 3: (2.0, 0.25)}
    for w in (None, weights):
        tn = ttn.HTN_from_clauses(inst["clauses"], weights=w, mode=mode,
                                  device=CPU)
        got = complex(tn.contract(..., output_inds=())).real
        want = complex(jtn.HTN_from_clauses(
            inst["clauses"], weights=w, mode=mode).contract(
                ..., output_inds=())).real
        assert got == pytest.approx(want, rel=1e-12)
        assert got == pytest.approx(_count_sat(inst["clauses"], 4, w),
                                    rel=1e-12)


def test_weighted_cnf_parse_matches():
    text = "p wcnf 2 2\nw 1 0.3 0\nw -2 0.6 0\n1 2 0\n-1 0\n"
    assert ttn.cnf_file_parse(text) == jtn.cnf_file_parse(text)


@pytest.mark.parametrize("Lx,Ly,count", [(2, 4, 5), (3, 4, 11)])
def test_dimer_coverings_count(Lx, Ly, count):
    edges = ttn.edges_2d_square(Lx, Ly)
    got = complex(ttn.TN_dimer_covering_from_edges(edges, device=CPU)
                  .contract(..., output_inds=())).real
    want = complex(jtn.TN_dimer_covering_from_edges(edges).contract(
        ..., output_inds=())).real
    assert got == want == pytest.approx(count)
