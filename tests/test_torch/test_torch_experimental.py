"""quimb_torch's ``experimental/`` extras (the CP decomposition, the
PEPS-DMRG virtual operators and product expectations, the translationally
invariant CTMRG, the network marginals, the isometric network builder and
the autojit decorator) and ``utils``' leftovers against quimb_tpu's, on
the CPU. Inputs come from ``np.random.default_rng(seed)`` in float64 to
both packages; the random builders (CP start factors, the isometric
layers) draw from numpy in both, so they are compared value for value.
Tolerances: 1e-12 relative for one contraction or a short ALS run, 1e-10
for CTMRG's eigh-truncated growth over several steps and for the ALS
factors after 50 sweeps."""

import contextlib
import io
import itertools
import pickle

import numpy as np
import pytest
import torch

import quimb_tpu.experimental as jex
import quimb_tpu.tensor as jtn
import quimb_tpu.utils as jutils
import quimb_torch.experimental as tex
import quimb_torch.tensor as ttn
import quimb_torch.utils as tutils
from quimb_torch import convert

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().numpy()
    return np.asarray(x)


def _peps_pair(Lx=2, Ly=3, D=2, seed=1):
    rng = np.random.default_rng(seed)
    arrays = [[rng.standard_normal(
        [D] * sum((i < Lx - 1, j < Ly - 1, i > 0, j > 0)) + [2])
        for j in range(Ly)] for i in range(Lx)]
    j = jtn.PEPS(arrays, shape="urdlp")
    return j, convert.from_tpu_peps(j, device=CPU)


# -- the CP decomposition -------------------------------------------------------


def test_cp_decompose_matches():
    rng = np.random.default_rng(0)
    A, B, C = (rng.standard_normal((4, 2)) for _ in range(3))
    X = np.einsum("ar,br,cr->abc", A, B, C)
    tj = jtn.Tensor(X, inds=("a", "b", "c"))
    tt = ttn.Tensor(torch.as_tensor(X), inds=("a", "b", "c"))
    fj = jex.cp_decompose(tj, 2, steps=50, seed=1, bond_ind="r")
    ft = tex.cp_decompose(tt, 2, steps=50, seed=1, bond_ind="r")
    for a, b in zip(ft, fj):
        assert a.inds == b.inds
        np.testing.assert_allclose(_np(a.data), np.asarray(b.data),
                                   rtol=1e-10, atol=1e-10)
    R = _np(ft.contract(..., output_inds=("a", "b", "c"),
                        preserve_tensor=True).data)
    assert np.abs(R - X).max() < 1e-8


def test_cp_simplify_matches():
    rng = np.random.default_rng(0)
    d = 3
    D = np.zeros((d, d, d))
    for i in range(d):
        D[i, i, i] = 1.0
    W = rng.standard_normal((d, d))
    nets = []
    for pkg, arr in ((jtn, np.asarray), (ttn, torch.as_tensor)):
        nets.append(pkg.TensorNetwork([
            pkg.Tensor(arr(D), inds=("x", "y", "z")),
            pkg.Tensor(arr(W), inds=("z", "w"))]))
    tj = jex.cp_simplify(nets[0], atol=1e-8, steps=500, seed=3)
    tt = tex.cp_simplify(nets[1], atol=1e-8, steps=500, seed=3)
    assert tt.num_tensors == tj.num_tensors == 4
    out = ("x", "y", "w")
    vt = _np(tt.contract(..., output_inds=out, preserve_tensor=True).data)
    vj = np.asarray(tj.contract(..., output_inds=out,
                                preserve_tensor=True).data)
    v0 = _np(nets[1].contract(..., output_inds=out,
                              preserve_tensor=True).data)
    np.testing.assert_allclose(vt, vj, atol=1e-10)
    assert np.abs(vt - v0).max() < 1e-7


# -- virtual operators, product expectations ------------------------------------


def test_virtual_operators_and_product_expectations_match():
    j, t = _peps_pair()
    bond = next(i for i, tids in j.ind_map.items() if len(tids) == 2)
    Xj = np.asarray(jex.virtual_bond_operator(j, bond))
    Xt = _np(tex.virtual_bond_operator(t, bond))
    np.testing.assert_allclose(Xt, Xj, rtol=1e-12, atol=1e-12 * np.abs(
        Xj).max())
    Sj = np.asarray(jex.virtual_site_operator(j, (0, 0)))
    St = _np(tex.virtual_site_operator(t, (0, 0)))
    np.testing.assert_allclose(St, Sj, rtol=0, atol=1e-12 * np.abs(Sj).max())
    Z = np.diag([1.0, -1.0])
    X = np.array([[0.0, 1.0], [1.0, 0.0]])
    Sg_j = np.asarray(jex.virtual_site_operator(j, (1, 1),
                                                operators={(1, 1): X}))
    Sg_t = _np(tex.virtual_site_operator(t, (1, 1), operators={(1, 1): X}))
    np.testing.assert_allclose(Sg_t, Sg_j, atol=1e-12 * np.abs(Sg_j).max())
    where = [(0, 0), (0, 1)]
    ej = complex(jex.product_expectation_exact(j, [Z, Z], where))
    et = complex(tex.product_expectation_exact(t, [Z, Z], where))
    assert et == pytest.approx(ej, rel=1e-12, abs=1e-14)
    for md in (0, 1, 3):
        cj = complex(jex.product_expectation_cluster(j, [Z, X], where,
                                                     max_distance=md))
        ct = complex(tex.product_expectation_cluster(t, [Z, X], where,
                                                     max_distance=md))
        assert ct == pytest.approx(cj, rel=1e-12, abs=1e-14)


# -- translationally invariant CTMRG --------------------------------------------


def test_classical_ising_tensors_match():
    for a, b in zip(tex.classical_ising_T_A_C(0.37, j=0.8, h=0.1,
                                              device=CPU),
                    jex.classical_ising_T_A_C(0.37, j=0.8, h=0.1)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-14,
                                   atol=1e-15)


@pytest.mark.parametrize("L,chi,strip", [(4, 16, False), (8, 16, True),
                                         (12, 8, True), (16, 6, True)])
def test_ctmrg_partition_function_matches(L, chi, strip):
    beta = 0.4
    Tt = tex.classical_ising_T_A_C(beta, device=CPU)
    Tj = jex.classical_ising_T_A_C(beta)
    zt = tex.ctmrg_partition_function(*Tt, L, chi, strip_exponent=strip)
    zj = jex.ctmrg_partition_function(*Tj, L, chi, strip_exponent=strip)
    if strip:
        lt = np.log10(float(zt[0])) + zt[1]
        lj = np.log10(float(zj[0])) + zj[1]
        assert lt == pytest.approx(lj, rel=1e-10)
    else:
        assert float(zt) == pytest.approx(float(zj), rel=1e-10)
    assert Tt[0].device.type == "cpu"
    with pytest.raises(ValueError, match="even"):
        tex.ctmrg_partition_function(*Tt, 5, chi)
    # host arrays go to the given device
    z = tex.ctmrg_partition_function(*(np.asarray(x) for x in Tj), 4, 4,
                                     device=CPU)
    assert isinstance(z, torch.Tensor)


# -- marginals --------------------------------------------------------------------


def test_marginals_match_brute_force_and_quimb_tpu():
    from quimb_tpu.tensor.tnag.builders import (
        HTN_classical_partition_function_from_edges as jhtn,
    )
    from quimb_torch.tensor.tnag.builders import (
        HTN_classical_partition_function_from_edges as thtn,
    )

    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)]
    beta, h = 0.35, 0.4
    tj = jhtn(edges, beta=beta, h=h)
    tt = thtn(edges, beta=beta, h=h, device=CPU)
    inds = [f"s{i}" for i in range(4)]
    Z = 0.0
    marg = {ix: np.zeros(2) for ix in inds}
    for cfg in itertools.product([0, 1], repeat=4):
        s = [1 if c == 0 else -1 for c in cfg]
        w = np.exp(beta * (sum(s[a] * s[b] for a, b in edges) + h * sum(s)))
        Z += w
        for i, c in enumerate(cfg):
            marg[f"s{i}"][c] += w
    for normalized in (True, False):
        ws = tex.compute_all_marginals_via_slicing(tt, inds,
                                                   normalized=normalized)
        wa = tex.compute_all_marginals_via_autodiff(tt, inds,
                                                    normalized=normalized)
        ja = jex.compute_all_marginals_via_autodiff(tj, inds,
                                                    normalized=normalized)
        for ix in inds:
            want = marg[ix] / Z if normalized else marg[ix]
            tol = dict(rtol=1e-12, atol=1e-12 * np.abs(want).max())
            np.testing.assert_allclose(ws[ix], want, **tol)
            np.testing.assert_allclose(wa[ix], want, **tol)
            np.testing.assert_allclose(wa[ix], ja[ix], **tol)


def test_marginals_of_a_complex_network_keep_quimb_tpus_convention():
    rng = np.random.default_rng(4)
    arrs = [rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
            for _ in range(3)]
    inds = [("a", "b"), ("b", "c"), ("c", "a")]
    tj = jtn.TensorNetwork([jtn.Tensor(a, inds=i) for a, i in zip(arrs, inds)])
    tt = ttn.TensorNetwork([ttn.Tensor(torch.as_tensor(a), inds=i)
                            for a, i in zip(arrs, inds)])
    ja = jex.compute_all_marginals_via_autodiff(tj, ["a", "b"])
    ta = tex.compute_all_marginals_via_autodiff(tt, ["a", "b"])
    for ix in "ab":
        np.testing.assert_allclose(ta[ix], ja[ix], rtol=1e-12,
                                   atol=1e-12 * np.abs(ja[ix]).max())


# -- the isometric network builder ----------------------------------------------


def _dense(tn):
    return _np(tn.to_dense()).reshape(-1) if isinstance(
        tn.to_dense(), torch.Tensor) else np.asarray(tn.to_dense()).reshape(-1)


@pytest.mark.parametrize("n,max_bond,group", [(7, 4, 2), (6, 3, 3)])
def test_ttn_randtree_matches(n, max_bond, group):
    j = jex.TTN_randtree_rand(range(n), max_bond, group_size=group, seed=0)
    t = tex.TTN_randtree_rand(range(n), max_bond, group_size=group, seed=0,
                              device=CPU)
    assert isinstance(t, tex.TensorNetworkGenIso)
    assert [sorted(x.tags) for x in t] == [sorted(x.tags) for x in j]
    vt, vj = _dense(t), _dense(j)
    np.testing.assert_allclose(vt, vj, atol=1e-12)
    assert abs(np.linalg.norm(vt) - 1) < 1e-10
    tc = convert.from_tpu_tngen(j, device=CPU)
    assert type(tc) is tex.TensorNetworkGenIso
    assert [x.left_inds for x in tc] == [x.left_inds for x in j]
    np.testing.assert_allclose(_dense(tc), vj, atol=1e-12)


def test_layered_mera_like_matches():
    from quimb_tpu.gen.operators import pauli

    nets = []
    for ex, kw in ((jex, {}), (tex, {"device": CPU})):
        tn = ex.TensorNetworkGenIso.empty(range(4), phys_dim=2, **kw)
        tn.layer_unitary_rand((1, 2), seed=1)
        tn.next_layer()
        tn.layer_isometry_rand((0, 1), dim=4, seed=2)
        tn.layer_isometry_rand((2, 3), dim=4, seed=3)
        tn.next_layer()
        tn.layer_cap_rand(seed=4)
        nets.append((tn.isometrize(), tn))
    (jiso, jraw), (tiso, traw) = nets
    np.testing.assert_allclose(_dense(traw), _dense(jraw), atol=1e-12)
    np.testing.assert_allclose(_dense(tiso), _dense(jiso), atol=1e-12)
    Z = np.asarray(pauli("Z")).real
    ej = complex(jiso.local_expectation_exact(Z, 1)).real
    et = complex(tiso.local_expectation_exact(torch.tensor(Z), 1)).real
    assert et == pytest.approx(ej, abs=1e-12)


def test_layer_gates_and_1d_groupings_match():
    rng = np.random.default_rng(9)
    U = np.linalg.qr(rng.standard_normal((4, 4)))[0].reshape(2, 2, 2, 2)
    V = np.linalg.qr(rng.standard_normal((4, 3)))[0].reshape(2, 2, 3)
    c = rng.standard_normal((3, 2, 2))
    nets = []
    for ex, arr, kw in ((jex, np.asarray, {}),
                        (tex, torch.as_tensor, {"device": CPU})):
        tn = ex.TensorNetworkGenIso.empty(range(4), **kw)
        tn.layer_gate_raw(arr(U), (1, 2))
        tn.layer_gate_raw(arr(V), (0, 1))
        fill = np.random.default_rng(2)
        tn.layer_gate_fill_fn(lambda s: arr(fill.standard_normal(s)), "iso",
                              (2, 3), max_bond=2)
        assert tn.layer_ind(0) == tn._open[0]
        assert tn.layer_ind(5) == "__layer_5__"
        tn.layer_gate_raw(arr(c / np.linalg.norm(c)), (0, 2))
        with pytest.raises(ValueError):
            tn.layer_gate_fill_fn(lambda s: arr(np.ones(s)), "bogus", (0,),
                                  max_bond=2)
        nets.append(tn)
    out = ("k0", "k1", "k2", "k3")
    np.testing.assert_allclose(
        _np(nets[1].contract(..., output_inds=out, preserve_tensor=True).data),
        np.asarray(nets[0].contract(..., output_inds=out,
                                    preserve_tensor=True).data), atol=1e-12)
    from quimb_tpu.experimental.merabuilder import calc_1d_unis_isos as jc
    from quimb_torch.experimental.merabuilder import calc_1d_unis_isos as tc

    for n, bs, cyc in itertools.product((4, 6, 8), (2, 3), (True, False)):
        assert tc(list(range(n)), bs, cyc) == jc(list(range(n)), bs, cyc)


# -- the autojit decorator --------------------------------------------------------


def test_autojit_tn_is_eager_by_default():
    j, t = _peps_pair(2, 2, 2, seed=3)

    @tex.autojit_tn
    def norm(tn):
        return tn.H @ tn

    calls = []

    def spy(fn, **opts):
        calls.append(opts)
        return fn

    traced = tex.autojit_tn(decorator=spy, flag=1)(lambda tn: tn.H @ tn)
    want = complex(j.H @ j).real
    assert complex(norm(t)).real == pytest.approx(want, rel=1e-12)
    assert complex(traced(t)).real == pytest.approx(want, rel=1e-12)
    assert calls == [{"flag": 1}] and norm.__wrapped__.__name__ == "norm"


# -- utils' leftovers ---------------------------------------------------------------


def test_utils_leftovers_match(tmp_path):
    for x, err in ((1.23456, 0.0021), (123.456, 7.9), (0.5, 0.0), (1.0, 0.96),
                   (-3.14159, 0.000051)):
        assert tutils.format_number_with_error(x, err) == \
            jutils.format_number_with_error(x, err)
    for x in (3, (1, 2), [4, 5]):
        assert tutils.int2tup(x) == jutils.int2tup(x)
    for it in ("abcd", [1, 2, 3]):
        assert list(tutils.gen_bipartitions(it)) == \
            list(jutils.gen_bipartitions(it))
        assert list(tutils.gen_bipartitions_balanced_first(it)) == \
            list(jutils.gen_bipartitions_balanced_first(it))
    tree = {"a": [1, (2, 3)], "b": {"c": 4}}
    assert tutils.tree_map(lambda v: v * 2, tree) == \
        jutils.tree_map(lambda v: v * 2, tree)
    assert tutils.tree_flatten(tree) == jutils.tree_flatten(tree)
    assert list(tutils.tree_iter(tree)) == list(jutils.tree_iter(tree))
    assert tutils.tree_unflatten([9, 8, 7, 6], tree) == \
        jutils.tree_unflatten([9, 8, 7, 6], tree)
    seen = []
    tutils.tree_apply(seen.append, tree)
    assert seen == [1, 2, 3, 4]
    assert tutils.hash_kwargs_to_int(a=1, b="x") == \
        jutils.hash_kwargs_to_int(a=1, b="x")
    ys = [1.0, 0.5, 0.3, 0.2, 0.15, float("nan"), 0.12, 0.11]
    stats = [(tutils.RollingMeanVar(3), jutils.RollingMeanVar(3)),
             (tutils.RollingDiffMean(3), jutils.RollingDiffMean(3)),
             (tutils.ExponentialGeometricRollingDiffMean(),
              jutils.ExponentialGeometricRollingDiffMean())]
    for k, y in enumerate(ys):
        for a, b in stats:
            if isinstance(a, tutils.RollingMeanVar) and y != y:
                continue
            a.update(y) if not isinstance(
                a, tutils.ExponentialGeometricRollingDiffMean) else a.update(
                    y, x=float(k))
            b.update(y) if not isinstance(
                b, jutils.ExponentialGeometricRollingDiffMean) else b.update(
                    y, x=float(k))
    (a0, b0), (a1, b1), (a2, b2) = stats
    assert (a0.mean, a0.var, a0.std) == (b0.mean, b0.var, b0.std)
    assert a1.absmeandiff() == b1.absmeandiff()
    assert a2.value == b2.value and a2.dy == b2.dy

    @tutils.autocorrect_kwargs
    def f(alpha=1, beta=2):
        return alpha + beta

    assert f(alpha=3) == 5
    with pytest.raises(ValueError, match="alpha"):
        f(alpah=3)
    with pytest.warns(FutureWarning, match="new_f"):
        assert tutils.deprecated(f, "old_f", "new_f")(beta=1) == 2
    obj = {"x": np.arange(3)}
    tutils.save_to_disk(obj, tmp_path / "o.pkl")
    np.testing.assert_array_equal(
        jutils.load_from_disk(tmp_path / "o.pkl")["x"], obj["x"])
    np.testing.assert_array_equal(
        tutils.load_from_disk(tmp_path / "o.pkl")["x"], obj["x"])
    outs = []
    for u in (tutils, jutils):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            u.print_multi_line("a" * 30, "b" * 30, max_width=20)
            u.Verbosify(f, highlight="beta")(beta=4)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert tutils.find_library("numpy") and not tutils.find_library(
        "no_such_library_here")
    with pytest.raises(ImportError, match="plotly"):
        tutils.raise_cant_find_library_function("plotly")()
    with tutils.Timer() as timer:
        sum(range(10))
    assert timer.t >= 0
    assert repr(tutils.Leaf) == "Leaf" and tutils.is_leaf_object(tutils.Leaf)
    assert pickle.loads(pickle.dumps(tutils.LRU(3))).maxsize == 3
