"""quimb_torch's further belief propagation (``MPS1BP``, the lazy ``L1BP``
/ ``L2BP`` and ``compress_l2bp``, ``DIIS``, ``RegionGraph`` and
``gen_region_counts``, ``HD1GBP``) and the loop expansions' region
machinery of ``tnag`` against quimb_tpu's, in float64 on the CPU.

Both packages get one network, with the same index names, tags and
tensor ids where the engine iterates over sets of them (region graphs);
quimb_tpu's side runs on host arrays inside its
``contract_backend("numpy")``. The engines run the same updates in the
same order, so their estimates agree to 1e-10 relative; counting numbers
and regions are integers and sets, compared exactly.
"""

import numpy as np
import pytest
import torch

import quimb_tpu.tensor as jtn
import quimb_torch.tensor as ttn
from quimb_torch import convert
from quimb_torch.tensor import belief_propagation as tbp
from quimb_tpu.ops.contraction import contract_backend as jbackend
from quimb_tpu.tensor import belief_propagation as jbp

CPU = "cpu"
REL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread_host_reference():
    """One torch thread, and quimb_tpu on host numpy arrays."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with jbackend("numpy"):
        yield
    torch.set_num_threads(n)


def _psi(edges, D=2, seed=0):
    rng = np.random.default_rng(seed)
    j = jtn.TN_from_edges_and_fill_fn(lambda s: rng.normal(size=s), edges,
                                      D, phys_dim=2)
    j.apply_to_arrays(np.asarray)
    return j, convert.from_tpu_tngen(j, device=CPU)


def _same_tids(j):
    """quimb_tpu's network rebuilt with tensor ids t0, t1, ... and the
    port's copy with the same ids."""
    a = jtn.TensorNetwork([])
    b = ttn.TensorNetwork([])
    for i, x in enumerate(j.tensor_map.values()):
        a.add_tensor(jtn.Tensor(np.asarray(x.data), inds=x.inds,
                                tags=x.tags), tid=f"t{i}", virtual=True)
        b.add_tensor(ttn.Tensor(torch.from_numpy(np.array(x.data)),
                                inds=x.inds, tags=x.tags), tid=f"t{i}",
                     virtual=True)
    return a, b


# -- MPS1BP --------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(max_bond=2), dict(max_bond=4),
                                dict(max_bond=3, update="parallel",
                                     cutoff=1e-12)])
def test_mps1bp_matches(kw):
    j, t = _psi(jtn.edges_2d_square(2, 3), seed=1)
    nj, nt = j.make_norm(), t.make_norm()
    layers = ("KET", "BRA")
    a = tbp.contract_mps1bp(nt, layer_tags=layers, **kw)
    b = jbp.contract_mps1bp(nj, layer_tags=layers, **kw)
    assert complex(a) == pytest.approx(complex(b), rel=REL)
    bt = tbp.MPS1BP(nt, layer_tags=layers, **kw).run()
    bj = jbp.MPS1BP(nj, layer_tags=layers, **kw).run()
    assert bt.n_iter == bj.n_iter
    assert complex(bt.contract(strip_exponent=True)[0]) == pytest.approx(
        complex(bj.contract(strip_exponent=True)[0]), rel=REL)
    with pytest.raises(NotImplementedError, match="damping"):
        tbp.MPS1BP(nt, 2, layers, damping=0.5)


def test_mps1bp_is_exact_on_a_tree():
    j, t = _psi([(0, 1), (1, 2), (1, 3)], seed=2)
    nt = t.make_norm()
    est = tbp.contract_mps1bp(nt, max_bond=8, layer_tags=("KET", "BRA"),
                              tol=1e-12)
    assert complex(est) == pytest.approx(complex(nt.contract(...)),
                                         rel=1e-10)


# -- L1BP / L2BP -----------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, dict(damping=0.2)])
def test_l1bp_and_l2bp_match(kw):
    j, t = _psi(jtn.edges_2d_square(2, 3), seed=3)
    nj, nt = j.make_norm(), t.make_norm()
    a = tbp.contract_l1bp(nt, **kw)
    b = jbp.contract_l1bp(nj, **kw)
    assert complex(a) == pytest.approx(complex(b), rel=REL)
    a = tbp.contract_l2bp(t, strip_exponent=True, **kw)
    b = jbp.contract_l2bp(j, strip_exponent=True, **kw)
    assert a[1] == pytest.approx(b[1], rel=1e-12)
    bt, bj = tbp.L1BP(nt, **kw).run(), jbp.L1BP(nj, **kw).run()
    assert bt.n_iter == bj.n_iter and bt.links == bj.links
    for k, m in bj.messages.items():
        np.testing.assert_allclose(bt.messages[k].numpy(), np.asarray(m),
                                   rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="site_tags"):
        tbp.L1BP(ttn.TensorNetwork([ttn.Tensor(torch.ones(2),
                                               inds=("a",))]))


@pytest.mark.parametrize("max_bond", [1, 2])
def test_compress_l2bp_matches(max_bond):
    j, t = _psi(jtn.edges_2d_square(2, 2), D=3, seed=4)
    ct = tbp.compress_l2bp(t, max_bond=max_bond)
    cj = jbp.compress_l2bp(j, max_bond=max_bond)
    assert ct.max_bond() == cj.max_bond() == max_bond
    # the projector pair is fixed up to a gauge, which cancels in the state
    np.testing.assert_allclose(ct.to_dense().numpy(),
                               np.asarray(cj.to_dense()), atol=1e-10)
    same = t.copy()
    tbp.compress_l2bp(same, max_bond=max_bond, inplace=True)
    np.testing.assert_allclose(same.to_dense().numpy(),
                               ct.to_dense().numpy(), atol=1e-12)


# -- DIIS ----------------------------------------------------------------------


def test_diis_matches():
    """DIIS extrapolates the fixed point of a contracting affine map from
    a nest of arrays, as quimb_tpu's (its trees flattened by jax, the
    port's by torch's pytree functions)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    A = 0.4 * rng.normal(size=(5, 5)) / np.sqrt(5)
    b = rng.normal(size=5)

    def G(x):
        v = np.concatenate([np.asarray(x["a"]).ravel(),
                            np.asarray(x["b"][0]).ravel()])
        v = A @ v + b
        return v

    dt, dj = tbp.DIIS(max_history=3), jbp.DIIS(max_history=3)
    xt = {"a": torch.zeros(2, dtype=torch.float64),
          "b": [torch.zeros(3, dtype=torch.float64)]}
    xj = {"a": jnp.zeros(2), "b": [jnp.zeros(3)]}
    for _ in range(16):
        vt, vj = G(xt), G(xj)
        xt = dt.update({"a": torch.from_numpy(vt[:2]),
                        "b": [torch.from_numpy(vt[2:])]})
        xj = dj.update({"a": jnp.asarray(vj[:2]), "b": [jnp.asarray(vj[2:])]})
        np.testing.assert_allclose(xt["a"].numpy(), np.asarray(xj["a"]),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(xt["b"][0].numpy(),
                                   np.asarray(xj["b"][0]),
                                   rtol=1e-10, atol=1e-12)
    fixed = np.linalg.solve(np.eye(5) - A, b)
    np.testing.assert_allclose(np.concatenate([xt["a"].numpy(),
                                               xt["b"][0].numpy()]),
                               fixed, atol=1e-8)
    dt.reset()
    assert dt._last_out is None and not dt._trials


# -- region graphs ---------------------------------------------------------------


REGIONS = [{1, 2, 3, 4}, {3, 4, 5, 6}, {5, 6, 7, 8}, {2, 3, 6, 9}]


def _rg_view(rg):
    return {
        "regions": set(rg.regions),
        "counts": dict(rg.counts),
        "parents": {r: set(rg.get_parents(r)) for r in rg.regions},
        "children": {r: set(rg.get_children(r)) for r in rg.regions},
        "coparents": {r: set(rg.get_coparent_pairs(r)) for r in rg.regions},
        "levels": {r: rg.get_level(r) for r in rg.regions},
        "maximal": rg.get_maximal_regions(),
        "minimal": rg.get_minimal_regions(),
        "ancestors": {r: rg.get_maximal_ancestors(r) for r in rg.regions},
        "overlap": {r: rg.get_overlapping(r) for r in rg.regions},
        "descendents": {r: rg.get_descendents(r) for r in rg.regions},
        "total": rg.get_total_count(),
        "balanced": (rg.isbalanced(), rg.istotallybalanced()),
    }


@pytest.mark.parametrize("step", ["build", "autoprune", "autoextend",
                                  "remove"])
def test_region_graph_matches(step):
    rt, rj = tbp.RegionGraph(REGIONS), jbp.RegionGraph(REGIONS)
    for rg in (rt, rj):
        if step == "autoprune":
            rg.autoprune()
        elif step == "autoextend":
            rg.autoextend(regions=[REGIONS[0]])
        elif step == "remove":
            rg.remove_region(frozenset({3, 4}))
            rg.reset_info()
    assert _rg_view(rt) == _rg_view(rj)
    assert rt.check() and repr(rt) == repr(rj)
    for r in rt.regions:
        for child in rt.get_children(r):
            assert rt.get_message_parts((r, child)) == \
                rj.get_message_parts((r, child))
    # the Hasse diagram: one point a region at its level, as quimb_tpu's
    import matplotlib
    import matplotlib.pyplot as plt

    matplotlib.use("Agg")
    (ft, at), (fj, aj) = rt.draw(), rj.draw()
    pts = [[tuple(c.get_offsets()[0]) for c in a.collections]
           for a in (at, aj)]
    assert pts[0] == pts[1] and len(pts[0]) == len(rt.counts)
    plt.close(ft)
    plt.close(fj)


def test_gen_region_counts_matches():
    for auto in (True, False):
        assert tbp.gen_region_counts(REGIONS, autocomplete=auto) == \
            jbp.gen_region_counts(REGIONS, autocomplete=auto)


# -- generalized BP ------------------------------------------------------------


@pytest.mark.parametrize("damping", [0.5, 0.0])
def test_hd1gbp_matches(damping):
    h = jtn.HTN2D_classical_ising_partition_function(2, 3, 0.3, h=0.1)
    h.apply_to_arrays(np.asarray)
    j, t = _same_tids(h)
    # one region per plaquette of bond tensors
    regions = []
    for i in range(2):
        tags = {f"I0,{i}", f"I0,{i + 1}", f"I1,{i}", f"I1,{i + 1}"}
        regions.append({tid for tid, x in t.tensor_map.items()
                        if len(x.inds) == 2 and set(x.tags) <= tags})
    a = tbp.contract_hd1gbp(t, regions, damping=damping, max_iterations=50)
    b = jbp.contract_hd1gbp(j, regions, damping=damping, max_iterations=50)
    assert complex(a) == pytest.approx(complex(b), rel=REL)
    m, e = tbp.contract_hd1gbp(t, regions, damping=damping,
                               max_iterations=50, strip_exponent=True)
    assert complex(m) * 10**e == pytest.approx(complex(a), rel=1e-12)


# -- the loop expansions' regions ------------------------------------------------


def test_loop_regions_match():
    j, t = _psi(jtn.edges_2d_square(2, 3), seed=6)
    assert sorted(t._tid_to_site().values()) == \
        sorted(j._tid_to_site().values())
    for loops in ("gloops", "sloops"):
        for max_size in (None, 4):
            assert t._gloop_site_regions(loops, max_size) == \
                j._gloop_site_regions(loops, max_size)
    gt, gj = {}, {}
    tt = t.gauge_all_simple(gauges=gt)
    jj = j.gauge_all_simple(gauges=gj)
    region = frozenset(t.sites[:4])
    assert tt._region_norm2(region, gt) == pytest.approx(
        jj._region_norm2(region, gj), rel=1e-10)
