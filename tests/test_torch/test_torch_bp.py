"""quimb_torch's belief propagation (``tensor/belief_propagation/``: D1BP,
D2BP, HV1BP and the samplers) against quimb_tpu's, in float64 on the CPU.

Both packages get one network: built in quimb_tpu and carried across with
its index names (``convert``), so the engines visit the messages in one
order, or built by both packages' own builders from the same arguments.
quimb_tpu's side runs on host arrays inside its
``contract_backend("numpy")``. BP runs to a tolerance of 5e-6 on message
changes; two runs of the same updates agree far closer, so values are held
to 1e-10 relative (a log-partition function to 1e-12), and two different
engines at one fixed point to 1e-6 relative. The samplers draw from
``np.random.default_rng(seed)`` in both packages and give the same
configurations.
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
BETA = 0.2216544
REL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread_host_reference():
    """One torch thread, and quimb_tpu on host numpy arrays."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with jbackend("numpy"):
        yield
    torch.set_num_threads(n)


def _host(tn):
    tn = tn.copy()
    tn.apply_to_arrays(np.asarray)
    return tn


def _carry(j):
    """quimb_tpu's network on host arrays and the port's copy (same index
    names, tags and tensor order)."""
    j = _host(j)
    return j, convert.from_tpu_tensor_network(j, device=CPU)


def _ising_htn(L=(2, 2, 3), h=0.1):
    return _carry(jtn.HTN3D_classical_ising_partition_function(
        *L, beta=BETA, h=h))


def _tids(j, t):
    """quimb_tpu's tensor ids -> the port's, for networks of one tensor
    order."""
    return dict(zip(j.tensor_map, t.tensor_map))


def _log10(est):
    m, e = est
    return e + np.log10(abs(complex(m)))


def _peps(Lx=2, Ly=3, D=2, seed=0, cplx=False):
    rng = np.random.default_rng(seed)

    def fill(shape):
        x = rng.normal(size=shape)
        return x + 1j * rng.normal(size=shape) if cplx else x

    j = jtn.TN_from_edges_and_fill_fn(fill, jtn.edges_2d_square(Lx, Ly), D,
                                      phys_dim=2)
    j = _host(j)
    return j, convert.from_tpu_tngen(j, device=CPU)


def _heis2():
    S = {"x": np.array([[0, 1], [1, 0]]) / 2,
         "y": np.array([[0, -1j], [1j, 0]]) / 2,
         "z": np.array([[1, 0], [0, -1]]) / 2}
    return sum(np.kron(S[a], S[a]) for a in "xyz").real


# -- D1BP ----------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {},
    dict(damping=0.3),
    dict(update="parallel"),
])
def test_d1bp_matches(kw):
    j, t = _ising_htn()
    a = tbp.contract_d1bp(t, strip_exponent=True, **kw)
    b = jbp.contract_d1bp(j, strip_exponent=True, **kw)
    assert _log10(a) == pytest.approx(_log10(b), rel=1e-12)
    bt = tbp.D1BP(t, **kw).run()
    bj = jbp.D1BP(j, **kw).run()
    assert bt.n_iter == bj.n_iter and bt.converged == bj.converged
    np.testing.assert_allclose(bt.mdiffs, bj.mdiffs, rtol=1e-6, atol=1e-14)
    tid = _tids(j, t)
    for (ix, k), m in bj.messages.items():
        np.testing.assert_allclose(bt.messages[ix, tid[k]].numpy(),
                                   np.asarray(m), rtol=0, atol=1e-12)
    assert complex(bt.contract()) == pytest.approx(complex(bj.contract()),
                                                   rel=REL)


def test_d1bp_on_a_direct_network_matches():
    j, t = _carry(jtn.TN2D_classical_ising_partition_function(
        3, 3, BETA, h=0.2))
    a = tbp.contract_hd1bp(t)
    b = jbp.contract_hd1bp(j)
    assert complex(a) == pytest.approx(complex(b), rel=REL)
    exact = complex(t.contract(...))
    # a loopy network: BP is an estimate, within a few percent here
    assert abs(complex(a) / exact - 1) < 0.05


def test_d1bp_is_exact_on_a_tree():
    edges = [(0, 1), (1, 2), (1, 3), (3, 4)]
    rng = np.random.default_rng(2)
    j = jtn.TN_from_edges_and_fill_fn(lambda s: rng.random(s), edges, 2)
    j, t = _carry(j)
    est = tbp.contract_d1bp(t, tol=1e-13)
    assert complex(est) == pytest.approx(complex(t.contract(...)), rel=1e-12)


# -- HV1BP -------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, dict(damping=0.2)])
def test_hv1bp_matches(kw):
    j, t = _ising_htn()
    a = tbp.contract_hv1bp(t, strip_exponent=True, **kw)
    b = jbp.contract_hv1bp(j, strip_exponent=True, **kw)
    assert _log10(a) == pytest.approx(_log10(b), rel=1e-12)
    bt, bj = tbp.HV1BP(t, **kw).run(), jbp.HV1BP(j, **kw).run()
    assert bt.n_iter == bj.n_iter
    assert len(bt.groups) == len(bj.groups) == 2
    mt, tid = bt.get_messages(), _tids(j, t)
    for (ix, k), m in bj.get_messages().items():
        np.testing.assert_allclose(mt[ix, tid[k]].numpy(), np.asarray(m),
                                   rtol=0, atol=1e-12)


def test_hv1bp_and_hd1bp_reach_one_fixed_point():
    _, t = _ising_htn((3, 3, 2), h=0.1)
    a = tbp.contract_hv1bp(t, strip_exponent=True)
    b = tbp.contract_hd1bp(t, strip_exponent=True)
    assert _log10(a) == pytest.approx(_log10(b), rel=1e-6)


def test_hv1bp_matches_on_ksat():
    j, t = _carry(jtn.HTN_random_ksat(3, 6, alpha=3.0, seed=2))
    a = tbp.contract_hv1bp(t, strip_exponent=True)
    b = jbp.contract_hv1bp(j, strip_exponent=True)
    assert _log10(a) == pytest.approx(_log10(b), rel=1e-12)


def test_hv1bp_on_single_use_variables():
    """A variable in one clause only leaves an open index: the port's HV1BP
    sums that leg and agrees with D1BP (quimb_tpu's too), where quimb_tpu's
    HV1BP gathers another slot's message and misses by 10^1.7 here
    (ROADMAP §3)."""
    inst = jtn.random_ksat_instance(3, 10, alpha=2.0, seed=3)
    j, t = _carry(jtn.HTN_from_clauses(inst["clauses"], mode="parafac",
                                       var_ind_id="var{}"))
    assert any(len(tids) == 1 for tids in t.ind_map.values())
    a = tbp.contract_hv1bp(t, strip_exponent=True)
    b = jbp.contract_hd1bp(j, strip_exponent=True)
    assert _log10(a) == pytest.approx(_log10(b), rel=1e-6)
    c = jbp.contract_hv1bp(j, strip_exponent=True)
    assert abs(_log10(c) - _log10(b)) > 1.0


def test_hv1bp_warm_start_and_structure():
    j, t = _ising_htn((2, 2, 2))
    bt = tbp.HV1BP(t, max_iterations=3).run()
    msgs = bt.get_messages()
    again = tbp.HV1BP(t, messages=msgs)
    np.testing.assert_array_equal(again.M.numpy(), bt.M.numpy())
    with pytest.raises(ValueError, match="uniform bond dimension"):
        tbp.HV1BP(ttn.TensorNetwork([
            ttn.Tensor(torch.ones(2, 3), inds=("a", "b")),
            ttn.Tensor(torch.ones(3, 2), inds=("b", "a"))]))


def test_hv1bp_sums_an_open_leg():
    """An index held by one tensor only is summed over, as D1BP sums it
    (quimb_tpu's HV1BP gathers another slot's message there instead)."""
    rng = np.random.default_rng(3)
    ts = [ttn.Tensor(torch.from_numpy(rng.random((2, 2, 2))),
                     inds=("a", "b", "open")),
          ttn.Tensor(torch.from_numpy(rng.random((2, 2))), inds=("a", "c")),
          ttn.Tensor(torch.from_numpy(rng.random((2, 2))), inds=("c", "b"))]
    tn = ttn.TensorNetwork(ts)
    a = tbp.contract_hv1bp(tn, tol=1e-12)
    b = tbp.contract_d1bp(tn, tol=1e-12)
    assert complex(a) == pytest.approx(complex(b), rel=1e-9)


# -- D2BP ----------------------------------------------------------------------


@pytest.mark.parametrize("cplx", [False, True])
def test_d2bp_contract_and_expectations_match(cplx):
    j, t = _peps(cplx=cplx, seed=4)
    a = tbp.contract_d2bp(t, strip_exponent=True)
    b = jbp.contract_d2bp(j, strip_exponent=True)
    assert _log10(a) == pytest.approx(_log10(b), rel=1e-12)
    bt, bj = tbp.D2BP(t).run(), jbp.D2BP(j).run()
    assert bt.n_iter == bj.n_iter
    h2 = _heis2()
    Z = np.diag([1.0, -1.0])
    for G, where in ((h2, (t.sites[0], t.sites[1])), (Z, [t.sites[3]])):
        assert bt.local_expectation(G, where) == pytest.approx(
            bj.local_expectation(G, where), rel=REL)
    gt, gj = bt.compute_gauges(), bj.compute_gauges()
    assert set(gt) == set(gj)
    for ix in gj:
        np.testing.assert_allclose(gt[ix].numpy(), np.asarray(gj[ix]),
                                   rtol=0, atol=1e-10)
    for ix, g in tbp.gauge_d2bp(t).items():
        np.testing.assert_allclose(g.numpy(), gt[ix].numpy(), atol=1e-12)


def test_d2bp_damped_and_estimates_the_norm():
    j, t = _peps(3, 3, seed=5)
    a = tbp.contract_d2bp(t, damping=0.2)
    b = jbp.contract_d2bp(j, damping=0.2)
    assert complex(a) == pytest.approx(complex(b), rel=REL)
    exact = complex(t.make_norm().contract(...))
    assert abs(complex(a) / exact - 1) < 0.5


@pytest.mark.parametrize("max_bond", [1, 2])
def test_compress_d2bp_matches(max_bond):
    j, t = _peps(2, 3, D=3, seed=6)
    ct = tbp.compress_d2bp(t, max_bond=max_bond)
    cj = jbp.compress_d2bp(j, max_bond=max_bond)
    assert ct.max_bond() == cj.max_bond() <= max_bond
    # the projector pair on a bond is fixed up to a gauge, which cancels
    # in the state
    np.testing.assert_allclose(ct.to_dense().numpy(),
                               np.asarray(cj.to_dense()), atol=1e-10)
    for xt, xj in zip(ct, cj):
        assert float(torch.linalg.norm(xt.data)) == pytest.approx(
            float(np.linalg.norm(np.asarray(xj.data))), rel=1e-9)
    c2 = t.copy()
    tbp.compress_d2bp(c2, max_bond=max_bond, inplace=True)
    np.testing.assert_allclose(c2.to_dense().numpy(), ct.to_dense().numpy(),
                               atol=1e-12)


# -- samplers --------------------------------------------------------------------


def _satisfied(clauses, config, var="var{}"):
    return all(any((config[var.format(abs(v))] == 1) == (v > 0) for v in c)
               for c in clauses)


@pytest.mark.parametrize("sampler", ["hd1bp", "hv1bp"])
def test_hyper_samplers_match(sampler):
    # every variable in five clauses or more: no open index (see
    # test_hv1bp_on_single_use_variables); quimb_tpu's HV1BP compiles each
    # new shape of its eager operations, most of this test's time
    inst = jtn.random_ksat_instance(3, 4, alpha=3.0, seed=2)
    j, t = _carry(jtn.HTN_from_clauses(inst["clauses"], mode="parafac",
                                       var_ind_id="var{}"))
    out = [f"var{v}" for v in range(1, 5)]
    ct, tt, wt = getattr(tbp, f"sample_{sampler}")(t, output_inds=out,
                                                   seed=2)
    cj, tj, wj = getattr(jbp, f"sample_{sampler}")(j, output_inds=out,
                                                   seed=2)
    assert ct == cj
    assert wt == pytest.approx(wj, rel=1e-8)
    # the assignment satisfies every clause: the fixed network counts 1
    assert _satisfied(inst["clauses"], ct)
    assert complex(tt.contract(...)) == pytest.approx(1.0, abs=1e-12)


def test_hv1bp_sampler_fixes_every_index():
    j, t = _carry(jtn.HTN2D_classical_ising_partition_function(
        1, 2, BETA, h=0.3))
    ct, tt, wt = tbp.sample_hv1bp(t, seed=2)
    cj, _, wj = jbp.sample_hv1bp(j, seed=2)
    assert ct == cj and set(ct) == set(t.ind_map)
    assert wt == pytest.approx(wj, rel=1e-8)
    assert not tt.ind_map or all(len(x.inds) == 0 for x in tt)


def test_d2bp_sampler_matches():
    j, t = _peps(2, 2, seed=8)
    ct, _, wt = tbp.sample_d2bp(t, seed=5)
    cj, _, wj = jbp.sample_d2bp(j, seed=5)
    assert ct == cj and set(ct) == set(t.site_inds)
    assert wt == pytest.approx(wj, rel=1e-8)
    ct, _, _ = tbp.sample_d2bp(t, seed=5, bias=2.0)
    cj, _, _ = jbp.sample_d2bp(j, seed=5, bias=2.0)
    assert ct == cj


# -- common ----------------------------------------------------------------------


def test_common_helpers_match():
    j, t = _ising_htn((2, 1, 2))
    mj = jbp.initialize_hyper_messages(j)
    mt = tbp.initialize_hyper_messages(t)
    tid = _tids(j, t)
    assert set(mt) == {(ix, tid[k]) for ix, k in mj}
    for ix, k in mj:
        np.testing.assert_allclose(mt[ix, tid[k]].numpy(),
                                   np.asarray(mj[ix, k]))
    zs = [(2.0, 1), (-0.5, 2), (1j, -1)]
    for strip in (False, True):
        a = tbp.combine_local_contractions(zs, strip_exponent=strip)
        b = jbp.combine_local_contractions(zs, strip_exponent=strip)
        np.testing.assert_allclose(np.asarray(a, dtype=complex),
                                   np.asarray(b, dtype=complex), rtol=1e-14)
    assert tbp.combine_local_contractions([(0.0, 1)]) == 0.0
    bp = tbp.D1BP(t, max_iterations=2)
    assert np.isnan(bp.mdiff)
    bp.run()
    assert bp.mdiff == bp.mdiffs[-1]
    with pytest.raises(ValueError, match="damping"):
        tbp.D1BP(t, damping=1.5)
    # the convergence plot: the same lines as quimb_tpu's plot of the same
    # history (matplotlib's Agg backend)
    import matplotlib
    import matplotlib.pyplot as plt
    from quimb_tpu.utils_plot import plot_multi_series_zoom

    matplotlib.use("Agg")
    fig, ax = bp.plot()
    jfig, jax_ = plot_multi_series_zoom({"mdiff": bp.mdiffs})
    assert [list(ln.get_ydata()) for ln in ax.lines] == \
        [list(ln.get_ydata()) for ln in jax_.lines] == [list(bp.mdiffs)]
    plt.close(fig)
    plt.close(jfig)
