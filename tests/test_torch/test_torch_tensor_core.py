"""quimb_torch's tensor-network object layer (``tensor/core.py``,
``tensor/array_ops.py``, ``tensor/networking.py``, ``gen/rand.py``) against
quimb_tpu's, on the CPU, in float64 and complex128.

Each test builds one network from numpy arrays drawn from
``np.random.default_rng(seed)`` in both packages (the port's tensors are
CPU torch tensors) and runs the same operation on both. Results are
compared by what is gauge-free: a network is contracted to its outer
indices, a tensor is transposed to sorted indices. Tolerances, relative in
the Frobenius norm: 1e-12 for contractions, norms and singular values;
1e-10 for anything that passes through a split, whose factors two LAPACK
calls reproduce to round-off times the inverse spectral gap.
"""

import pickle

import numpy as np
import pytest
import torch

import quimb_tpu.tensor as jtn
import quimb_torch.tensor as ttn
from quimb_torch import convert
from quimb_torch.gen import rand as trand
from quimb_torch.ops import contraction as tctr
from quimb_torch.tensor import core as tcore

RTOL = 1e-12
SPLIT_TOL = 1e-10
DTYPES = ["float64", "complex128"]


def _rand(rng, shape, dtype):
    x = rng.standard_normal(shape)
    if dtype.startswith("complex"):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().numpy()
    return np.asarray(x)


def _dense(x):
    """A network's value on its outer indices (sorted), a tensor's data
    on sorted indices, or a scalar, as numpy."""
    if isinstance(x, (ttn.TensorNetwork, jtn.TensorNetwork)):
        outer = tuple(sorted(x.outer_inds()))
        x = x.contract(..., output_inds=outer, preserve_tensor=bool(outer))
    if isinstance(x, (ttn.Tensor, jtn.Tensor)):
        return _np(x.transpose(*sorted(x.inds)).data)
    return np.asarray(_np(x))


def _assert_close(t, j, rtol=RTOL):
    t, j = _dense(t), _dense(j)
    assert t.shape == j.shape
    assert np.linalg.norm(t - j) <= rtol * max(np.linalg.norm(j), 1e-300)


def _tensor(pkg, arr, inds, tags=None):
    data = torch.as_tensor(arr) if pkg is ttn else arr
    return pkg.Tensor(data, inds=inds, tags=tags)


def mps_arrays(L=6, chi=4, d=2, dtype="float64", seed=0):
    """Open-boundary MPS site arrays and their (inds, tags)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(L):
        inds = ((f"k{i}",) if i else ()) + (f"p{i}",) + (
            (f"k{i + 1}",) if i < L - 1 else ())
        shape = [chi if ix.startswith("k") else d for ix in inds]
        out.append((_rand(rng, shape, dtype), inds, {f"I{i}", "KET"}))
    return out


def grid_arrays(nx=2, ny=3, D=3, d=2, dtype="float64", seed=0):
    """A loopy nx x ny PEPS-like network with physical indices."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(nx):
        for j in range(ny):
            inds = [f"p{i},{j}"]
            for a, b in (((i - 1, j), (i, j)), ((i, j), (i + 1, j)),
                         ((i, j - 1), (i, j)), ((i, j), (i, j + 1))):
                if 0 <= a[0] < nx and 0 <= a[1] < ny and \
                        0 <= b[0] < nx and 0 <= b[1] < ny:
                    inds.append(f"b{a}-{b}")
            shape = [d] + [D] * (len(inds) - 1)
            out.append((_rand(rng, shape, dtype), tuple(inds),
                        {f"I{i},{j}", f"X{i}", f"Y{j}"}))
    return out


def build(pkg, arrays):
    """The network of ``arrays`` in ``pkg``, its tensor ids fixed: the
    spanning trees of the tree gauges visit sets of tids, so equal ids
    give both packages one order."""
    tn = pkg.TensorNetwork([])
    for i, a in enumerate(arrays):
        tn.add_tensor(_tensor(pkg, *a), tid=f"t{i}", virtual=True)
    return tn


def both(arrays):
    return build(ttn, arrays), build(jtn, arrays)


# -- Tensor --------------------------------------------------------------------


TENSOR_OPS = {
    "transpose": lambda t, pkg: t.transpose("c", "a", "b"),
    "fuse": lambda t, pkg: t.fuse({"x": ("b", "c")}),
    "fuse_unfuse": lambda t, pkg: t.fuse({"x": ("b", "c")}).unfuse(
        {"x": ("b", "c")}, {"x": (3, 4)}),
    "arith": lambda t, pkg: 2 * t - t.transpose("b", "a", "c") * 0.5 + 1,
    "neg_div": lambda t, pkg: -(t / 3.0),
    "conj": lambda t, pkg: t.conj(),
    "H": lambda t, pkg: t.H,
    "norm": lambda t, pkg: t.norm(),
    "normalize": lambda t, pkg: t.normalize(),
    "isel": lambda t, pkg: t.isel({"b": 1}),
    "sum_reduce": lambda t, pkg: t.sum_reduce("b"),
    "vector_reduce": lambda t, pkg: t.vector_reduce(
        "c", np.arange(4.0) - 1.5),
    "multiply_index_diagonal": lambda t, pkg: t.multiply_index_diagonal(
        "a", np.array([0.5, -2.0])),
    "gate": lambda t, pkg: t.gate(np.array([[0.0, 1.0], [1.0, 0.5]]), "a"),
    "new_ind": lambda t, pkg: _new_ind(t),
    "expand_ind": lambda t, pkg: _expand(t),
    "squeeze": lambda t, pkg: _new_ind(t).squeeze(),
    "flip": lambda t, pkg: t.flip("c"),
    "trace": lambda t, pkg: pkg.Tensor(t.data[:, :2, :2],
                                       inds=("a", "b", "c")).trace("b",
                                                                   "c"),
    "collapse_repeated": lambda t, pkg: pkg.Tensor(
        t.data[:, :2, :2], inds=("a", "b", "b")).collapse_repeated(),
    "symmetrize": lambda t, pkg: pkg.Tensor(
        t.data[:, :3, :3], inds=("a", "b", "c")).symmetrize("b", "c"),
    "singular_values": lambda t, pkg: t.singular_values(("a", "c")),
    "entropy": lambda t, pkg: t.entropy(("a",)),
    "largest_element": lambda t, pkg: t.largest_element(),
    "overlap": lambda t, pkg: t.overlap(t.transpose("b", "c", "a") * 2),
    "new_ind_pair_with_identity": lambda t, pkg:
        t.new_ind_pair_with_identity("x", "y", 3),
    "new_ind_pair_diag": lambda t, pkg: t.new_ind_pair_diag("a", "x", "y"),
    "new_ind_with_identity": lambda t, pkg: pkg.Tensor(
        t.data[:, :2, :2], inds=("a", "b", "c")).new_ind_with_identity(
        "x", ("b",), ("c",)),
    "direct_product": lambda t, pkg: t.direct_product(t * 2, ("a",)),
    "isometrize": lambda t, pkg: t.isometrize(("b", "c")),
    "astype": lambda t, pkg: t.astype("complex128"),
    "tensor_balance_bond": lambda t, pkg: _balance(t, pkg),
}


def _new_ind(t):
    t = t.copy()
    t.new_ind("n", size=1, axis=1)
    return t


def _expand(t):
    t = t.copy()
    t.expand_ind("a", 5)
    return t


def _balance(t, pkg):
    a, b = t.copy(), pkg.Tensor(t.data[0], inds=("z", "c"))
    pkg.tensor_balance_bond(a, b)
    return a


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", sorted(TENSOR_OPS))
def test_tensor_ops_match_quimb_tpu(op, dtype):
    arr = _rand(np.random.default_rng(1), (2, 3, 4), dtype)
    res = []
    for pkg in (ttn, jtn):
        t = _tensor(pkg, arr, ("a", "b", "c"), tags={"T"})
        res.append(TENSOR_OPS[op](t, pkg))
    if isinstance(res[0], ttn.Tensor):
        assert set(res[0].inds) == set(res[1].inds)
        assert set(res[0].tags) == set(res[1].tags)
    tol = SPLIT_TOL if op in ("isometrize", "singular_values",
                              "entropy") else RTOL
    _assert_close(*res, rtol=tol)


def test_tensor_properties_and_idx():
    arr = _rand(np.random.default_rng(2), (2, 3, 4), "float64")
    t = _tensor(ttn, arr, "abc", tags="T")
    j = _tensor(jtn, arr, "abc", tags="T")
    assert t.shape == j.shape == (2, 3, 4) and t.size == 24
    assert t.inds == ("a", "b", "c") and t.ind_size("b") == 3
    assert t.idxmax() == j.idxmax() and t.idxmin() == j.idxmin()
    assert t.idxmax(abs) == j.idxmax(abs)
    assert t.iscomplex() is False and t.backend == "torch"
    assert t.almost_equals(t.copy())
    assert t.dtype == torch.float64
    assert ttn.Tensor(torch.tensor(2.5), inds=()).item() == 2.5
    with pytest.raises(ValueError):
        t.transpose("a", "b")
    with pytest.raises(ValueError):
        ttn.Tensor(torch.ones(2, 3), inds=("a",))


GET_MODES = [None, "tensors", "arrays", "values"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("absorb", ["both", "left", "right", None])
@pytest.mark.parametrize("get", GET_MODES)
def test_tensor_split_get_modes(get, absorb, dtype):
    arr = _rand(np.random.default_rng(3), (4, 5, 6), dtype)
    out = []
    for pkg in (ttn, jtn):
        t = _tensor(pkg, arr, ("a", "b", "c"), tags={"T"})
        out.append(pkg.tensor_split(t, ("a", "c"), get=get, absorb=absorb,
                                    max_bond=7, cutoff=0.0, ltags="L",
                                    rtags="R", bond_ind="x"))
    t, j = out
    if get == "values":
        _assert_close(t, j, rtol=RTOL)
        return
    if get == "arrays":
        assert len(t) == len(j)
        for a, b in zip(t, j):
            assert _np(a).shape == np.asarray(b).shape
        tn_t = ttn.TensorNetwork(_arrays_as_tensors(ttn, t))
        tn_j = jtn.TensorNetwork(_arrays_as_tensors(jtn, j))
        _assert_close(tn_t, tn_j, rtol=SPLIT_TOL)
        return
    if get == "tensors":
        t = ttn.TensorNetwork(t if isinstance(t, list) else [t])
        j = jtn.TensorNetwork(j if isinstance(j, list) else [j])
    assert isinstance(t, ttn.TensorNetwork)
    assert {tuple(sorted(x.tags)) for x in t} == \
        {tuple(sorted(x.tags)) for x in j}
    _assert_close(t, j, rtol=SPLIT_TOL)


def _arrays_as_tensors(pkg, arrays):
    """get='arrays' of a split of ('a', 'c') | ('b',): (left, [s,] right),
    the bond named 'x' (and 'y' right of s)."""
    if len(arrays) == 2:
        left, right = arrays
        return [pkg.Tensor(left, inds=("a", "c", "x")),
                pkg.Tensor(right, inds=("x", "b"))]
    left, s, right = arrays
    return [pkg.Tensor(left, inds=("a", "c", "x")),
            pkg.Tensor(s, inds=("x",)),
            pkg.Tensor(right, inds=("x", "b"))]


@pytest.mark.parametrize("method", ["svd", "qr", "lq", "svd:eig", "polar_right",
                                    "lu", "qr:cholesky"])
def test_tensor_split_methods(method):
    arr = _rand(np.random.default_rng(4), (4, 5, 6), "complex128")
    out = []
    for pkg in (ttn, jtn):
        t = _tensor(pkg, arr, ("a", "b", "c"))
        out.append(t.split(("a", "c"), method=method, cutoff=0.0))
    _assert_close(*out, rtol=SPLIT_TOL)


# -- TensorNetwork: structure ----------------------------------------------------


def test_maps_select_reindex_retag_partition():
    t, j = both(grid_arrays())
    assert t.check() and j.check()
    assert set(t.outer_inds()) == set(j.outer_inds())
    assert set(t.inner_inds()) == set(j.inner_inds())
    assert set(t.tag_map) == set(j.tag_map)
    assert t.ind_sizes() == j.ind_sizes()
    assert t.max_bond() == j.max_bond()
    for tags, which in (("X0", "all"), (("X0", "Y1"), "any"),
                        (("X0", "Y1"), "all"), (("X0",), "!all")):
        assert {frozenset(x.tags) for x in t.select(tags, which=which)} == \
            {frozenset(x.tags) for x in j.select(tags, which=which)}
    rt = t.reindex({"p0,0": "q"}).retag({"X0": "row0"})
    rj = j.reindex({"p0,0": "q"}).retag({"X0": "row0"})
    assert set(rt.outer_inds()) == set(rj.outer_inds())
    assert set(rt.tag_map) == set(rj.tag_map)
    _assert_close(rt, rj)
    (at, bt), (aj, bj) = t.partition("X0"), j.partition("X0")
    assert at.num_tensors == aj.num_tensors
    assert bt.num_tensors == bj.num_tensors
    # virtual selections share tensors with their parent
    sel = t.select("I0,0")
    sel["I0,0"].modify(data=sel["I0,0"].data * 2)
    assert torch.equal(t["I0,0"].data, sel["I0,0"].data)
    assert t.geometry_hash() == j.geometry_hash()
    assert len(t.subgraphs()) == len(j.subgraphs()) == 1


def test_neighbors_local_and_networking():
    t, j = both(grid_arrays())
    assert {frozenset(x.tags) for x in t.select_neighbors("I0,0")} == \
        {frozenset(x.tags) for x in j.select_neighbors("I0,0")}
    assert {frozenset(x.tags) for x in t.select_local("I0,0")} == \
        {frozenset(x.tags) for x in j.select_local("I0,0")}
    assert t.istree() == j.istree() and t.isconnected() == j.isconnected()
    tc = t.compute_centralities()
    jc = j.compute_centralities()
    assert np.allclose(sorted(tc.values()), sorted(jc.values()))
    assert t.tensor_map[t.most_central_tid()].tags == \
        j.tensor_map[j.most_central_tid()].tags
    assert len(list(t.gen_loops())) == len(list(j.gen_loops()))


# -- TensorNetwork: contraction ------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("optimize", ["greedy", "auto", "optimal"])
def test_contract_all(optimize, dtype):
    t, j = both(grid_arrays(dtype=dtype))
    _assert_close(t.contract(..., optimize=optimize),
                  j.contract(..., optimize=optimize))
    _assert_close(t.make_norm().contract(all, optimize=optimize),
                  j.make_norm().contract(all, optimize=optimize))


@pytest.mark.parametrize("optimize", ["greedy", "auto"])
def test_contraction_cost_width_path(optimize):
    t, j = both(mps_arrays(L=10, chi=8))
    nt, nj = t.make_norm(), j.make_norm()
    assert nt.contraction_cost(optimize="greedy") == \
        nj.contraction_cost(optimize="greedy")
    assert nt.contraction_width(optimize="greedy") == \
        nj.contraction_width(optimize="greedy")
    assert nt.contraction_path(optimize="greedy") == \
        nj.contraction_path(optimize="greedy")
    info = nt.contraction_info(optimize=optimize)
    assert info.flops > 0 and info.width > 0
    assert nt.contract(get="expression", optimize=optimize).path == info.path


@pytest.mark.parametrize("dtype", DTYPES)
def test_norm_overlap_and_make_norm(dtype):
    t, j = both(mps_arrays(dtype=dtype))
    t2, j2 = both(mps_arrays(dtype=dtype, seed=5))
    _assert_close(t.norm(), j.norm())
    _assert_close(t.overlap(t2), j.overlap(j2))
    _assert_close(t.make_overlap(t2).contract(all),
                  j.make_overlap(j2).contract(all))
    _assert_close(t.H @ t2, j.H @ j2)
    nt, kt, bt = t.make_norm(return_all=True)
    assert set(nt.tag_map) == set(j.make_norm().tag_map)
    assert "BRA" in bt.tag_map and "KET" in kt.tag_map


@pytest.mark.parametrize("dtype", DTYPES)
def test_contract_tags_and_cumulative(dtype):
    t, j = both(mps_arrays(L=8, dtype=dtype))
    nt, nj = t.make_norm(), j.make_norm()
    tags = [f"I{i}" for i in range(8)]
    _assert_close(nt.contract_cumulative(tags), nj.contract_cumulative(tags))
    _assert_close(nt >> tags, nj >> tags)
    ct = nt.contract_tags(["I2", "I3"], which="any")
    cj = nj.contract_tags(["I2", "I3"], which="any")
    assert ct.num_tensors == cj.num_tensors
    _assert_close(ct, cj)
    _assert_close(nt ^ ["I0", "I1"], nj ^ ["I0", "I1"])
    _assert_close(t.contract(["I0", "I1", "I2"]),
                  j.contract(["I0", "I1", "I2"]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_contract_between_ind_and_around(dtype):
    for arrays in (grid_arrays(dtype=dtype), mps_arrays(dtype=dtype)):
        t, j = both(arrays)
        tag0 = sorted(t.tag_map)[0]
        for tn in (t, j):
            nb = tn.select_neighbors(tag0)[0]
            tn.contract_between(tag0, tuple(nb.tags))
        _assert_close(t, j)
        t, j = both(arrays)
        ix = t.inner_inds()[0]
        t.contract_ind(ix)
        j.contract_ind(ix)
        _assert_close(t, j)
    t, j = both(grid_arrays(dtype=dtype))
    _assert_close(t.contract_around("I0,0"), j.contract_around("I0,0"))
    _assert_close(t.contract_around("I0,1", max_bond=3),
                  j.contract_around("I0,1", max_bond=3), rtol=SPLIT_TOL)


def test_to_dense_trace_split_and_isel():
    t, j = both(mps_arrays(L=4))
    _assert_close(t.to_dense(("p0", "p1"), ("p2", "p3")),
                  j.to_dense(("p0", "p1"), ("p2", "p3")))
    _assert_close(t.isel({"p0": 1, "p3": 0}), j.isel({"p0": 1, "p3": 0}))
    st = t.split(("p0", "p1"), cutoff=0.0)
    sj = j.split(("p0", "p1"), cutoff=0.0)
    _assert_close(st, sj, rtol=SPLIT_TOL)
    tt = ttn.Tensor(torch.as_tensor(np.eye(3)), inds=("a", "b"))
    jt = jtn.Tensor(np.eye(3), inds=("a", "b"))
    _assert_close(ttn.TensorNetwork([tt]).trace("a", "b"),
                  jtn.TensorNetwork([jt]).trace("a", "b"))
    cuts_t = list(t.cut_iter("k1"))
    assert len(cuts_t) == 4
    _assert_close(sum(_dense(c) for c in cuts_t), _dense(j))


# -- TensorNetwork: bond operations ----------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_canonize_between(dtype):
    t, j = both(mps_arrays(dtype=dtype))
    t.canonize_between("I2", "I3")
    j.canonize_between("I2", "I3")
    _assert_close(t, j)
    _assert_close(t["I2"], j["I2"], rtol=SPLIT_TOL)  # QR is sign-fixed
    A = _np(t["I2"].transpose("k2", "p2", "k3").data).reshape(-1, 4)
    assert np.allclose(A.conj().T @ A, np.eye(4), atol=1e-12)


COMPRESS_MODES = [("basic", {}), ("virtual-tree", {}),
                  ("full-bond", {"fit": False})]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode,extra", COMPRESS_MODES)
@pytest.mark.parametrize("net", ["mps", "grid"])
def test_compress_between_modes(net, mode, extra, dtype):
    arrays = mps_arrays(chi=6, dtype=dtype) if net == "mps" else \
        grid_arrays(D=4, dtype=dtype)
    t, j = both(arrays)
    a, b = (("I2", "I3") if net == "mps" else ("I0,1", "I1,1"))
    for tn in (t, j):
        tn.compress_between(a, b, mode=mode, max_bond=3, cutoff=0.0,
                            **extra)
    assert t.bond_size(a, b) == j.bond_size(a, b) == 3
    _assert_close(t, j, rtol=SPLIT_TOL)


def test_compress_between_lossless_and_canonize_absorb_modes():
    t, j = both(mps_arrays(chi=4))
    ref = _dense(j)
    for absorb in ("left", "right", "both"):
        t2 = t.copy()
        t2.canonize_between("I1", "I2", absorb=absorb)
        _assert_close(_dense(t2), ref)
    t.compress_between("I2", "I3", cutoff=1e-12)
    _assert_close(_dense(t), ref, rtol=SPLIT_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_compress_all_variants(dtype):
    for name, kw in (("compress_all", {"max_bond": 2, "cutoff": 0.0}),
                     ("compress_all_tree", {"max_bond": 2, "cutoff": 0.0}),
                     ("compress_all_simple", {"max_bond": 2,
                                              "cutoff": 0.0})):
        t, j = both(mps_arrays(chi=4, dtype=dtype))
        _assert_close(getattr(t, name)(**kw), getattr(j, name)(**kw),
                      rtol=SPLIT_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gauges_preserve_value_and_match(dtype):
    t, j = both(grid_arrays(dtype=dtype))
    ref = _dense(j)
    gt = t.gauge_all_simple(max_iterations=4)
    gj = j.gauge_all_simple(max_iterations=4)
    _assert_close(gt, gj, rtol=SPLIT_TOL)
    _assert_close(gt, ref, rtol=SPLIT_TOL)
    # with gauges handed back, the networks (Vidal form) and gauges match
    gauges_t, gauges_j = {}, {}
    vt = t.gauge_all_simple(max_iterations=3, gauges=gauges_t)
    vj = j.gauge_all_simple(max_iterations=3, gauges=gauges_j)
    assert set(gauges_t) == set(gauges_j)
    for ix in gauges_t:
        _assert_close(gauges_t[ix], gauges_j[ix], rtol=SPLIT_TOL)
    with vt.gauge_simple_temp(gauges_t):
        _assert_close(vt, ref, rtol=SPLIT_TOL)
    for name in ("gauge_all_canonize", "balance_bonds", "equalize_norms",
                 "gauge_all_random"):
        _assert_close(getattr(t, name)(), ref, rtol=SPLIT_TOL)
    _assert_close(t.canonize_around("I0,0"), ref, rtol=SPLIT_TOL)
    _assert_close(t.gauge_local("I0,0"), ref, rtol=SPLIT_TOL)


def test_equalize_norms_exponent_and_multiply():
    t, j = both(mps_arrays())
    et, ej = t.equalize_norms(), j.equalize_norms()
    assert et.exponent == pytest.approx(ej.exponent, rel=RTOL)
    _assert_close(et.contract(...), ej.contract(...))
    for x in (3.0, -2.0, 1j):
        if x == 1j:
            continue
        _assert_close(t.multiply(x), j.multiply(x))
    _assert_close(-t, -j)
    _assert_close(t * 2, j * 2)
    _assert_close(t.distribute_exponent(), j.distribute_exponent())


def test_fuse_multibonds_and_make_single_bond():
    rng = np.random.default_rng(6)
    arrays = [(_rand(rng, (2, 3, 4), "float64"), ("a", "x", "y"), "A"),
              (_rand(rng, (3, 4, 5), "float64"), ("x", "y", "b"), "B")]
    t, j = both(arrays)
    ft, fj = t.fuse_multibonds(), j.fuse_multibonds()
    assert ft.num_indices == fj.num_indices == 3
    _assert_close(ft, fj)
    t2, j2 = both(arrays)
    ttn.tensor_make_single_bond(t2["A"], t2["B"])
    jtn.tensor_make_single_bond(j2["A"], j2["B"])
    _assert_close(t2, j2)


def test_replace_with_svd_compressor_and_select_local():
    t, j = both(mps_arrays(chi=4))
    rt = t.replace_with_svd(["I2", "I3"], left_inds=("k2", "p2"),
                            which="any", max_bond=3, cutoff=0.0)
    rj = j.replace_with_svd(["I2", "I3"], left_inds=("k2", "p2"),
                            which="any", max_bond=3, cutoff=0.0)
    _assert_close(rt, rj, rtol=SPLIT_TOL)
    ct = t.insert_compressor_between_regions(["I0", "I1", "I2"], ["I3"],
                                             max_bond=2, cutoff=0.0)
    cj = j.insert_compressor_between_regions(["I0", "I1", "I2"], ["I3"],
                                             max_bond=2, cutoff=0.0)
    _assert_close(ct, cj, rtol=SPLIT_TOL)


def test_contract_compressed_and_network_sum():
    t, j = both(grid_arrays(D=3))
    _assert_close(t.contract_compressed(max_bond=4),
                  j.contract_compressed(max_bond=4), rtol=SPLIT_TOL)
    a, b = both(mps_arrays(seed=1)), both(mps_arrays(seed=2))
    _assert_close(ttn.tensor_network_sum(a[0], b[0]),
                  jtn.tensor_network_sum(a[1], b[1]))


class _CompressFailed(RuntimeError):
    pass


@pytest.mark.parametrize("call", [
    lambda tn: tn.contract_compressed(max_bond=2, compress_mode="basic"),
    lambda tn: tn.contract_around("I0,1", max_bond=2),
    lambda tn: tn.compress_all_simple(max_bond=2),
    lambda tn: tn.compress_all_tree(max_bond=2),
], ids=["contract_compressed", "contract_around", "compress_all_simple",
        "compress_all_tree"])
def test_bond_compression_failure_reaches_caller(call, monkeypatch):
    """A failed bond compression (a solver error, an out-of-memory error
    on the card) propagates: the network never comes back with a bond
    silently left uncompressed. Only the truncating calls fail: the
    simple-update gauge's lossless ones run as they are."""
    real = tcore.tensor_compress_bond

    def fail(*args, **kwargs):
        if kwargs.get("max_bond") is None:
            return real(*args, **kwargs)
        raise _CompressFailed("bond compression failed")

    monkeypatch.setattr(tcore, "tensor_compress_bond", fail)
    t, _ = both(grid_arrays(D=3))
    with pytest.raises(_CompressFailed):
        call(t)


def test_insert_gauge_operator_cut_and_expand():
    t, j = both(mps_arrays(chi=3))
    U = np.array([[2.0, 1.0, 0.0], [0.0, 1.0, 0.5], [1.0, 0.0, 1.0]])
    t.insert_gauge(U, "I1", "I2")
    j.insert_gauge(U, "I1", "I2")
    _assert_close(t, j)
    _assert_close(t.insert_operator(U, "I2", "I3", tags="OP"),
                  j.insert_operator(U, "I2", "I3", tags="OP"))
    et = t.expand_bond_dimension(5)
    ej = j.expand_bond_dimension(5)
    assert et.max_bond() == ej.max_bond() == 5
    _assert_close(et, ej)
    for tn in (t, j):
        tn.cut_bond("k1", "L", "R")
    _assert_close(t, j)


def test_isel_squeeze_astype_conj_and_pickle():
    t, j = both(mps_arrays(dtype="complex128"))
    _assert_close(t.isel({"p0": 0, "p4": 1}), j.isel({"p0": 0, "p4": 1}))
    _assert_close(t.conj(), j.conj())
    _assert_close(t.H, j.H)
    _assert_close(t.astype("complex128"), j.astype("complex128"))
    sq = t.copy()
    sq["I0"].new_ind("one", size=1)
    _assert_close(sq.squeeze(), j)
    back = pickle.loads(pickle.dumps(t))
    _assert_close(back, j)


# -- the once-deferred drawing methods ------------------------------------------


DEFERRED = {
    "draw": ("16", lambda tn: tn.draw(get="fig")),
    "graph": ("16", lambda tn: tn.graph(get="fig")),
    "draw_3d": ("16", lambda tn: tn.draw_3d(get="fig")),
    "visualize_tensors": ("16", lambda tn: tn.visualize_tensors(
        return_fig=True)),
    "tensor_draw": ("16", lambda tn: tn["I0"].draw(get="fig")),
    "tensor_visualize": ("16", lambda tn: tn["I0"].visualize(
        return_fig=True)),
}


def _fig_signature(fig):
    """Each axes' kind, its artist counts, its texts and (2D) the data of
    its lines and point collections, rounded to 1e-10."""
    sig = []
    for ax in fig.axes:
        entry = [ax.name, len(ax.lines), len(ax.collections),
                 len(ax.patches), sorted(t.get_text() for t in ax.texts)]
        if ax.name != "3d":
            data = [ln.get_xydata().ravel() for ln in ax.lines]
            data += [np.asarray(c.get_offsets()).ravel()
                     for c in ax.collections]
            entry.append(np.round(np.concatenate(data + [np.zeros(0)]),
                                  10).tolist())
        sig.append(entry)
    return sig


@pytest.mark.parametrize("name", sorted(DEFERRED))
def test_deferred_methods_name_their_item(name):
    """The drawing methods that ROADMAP item 16 deferred now draw what
    quimb_tpu's draw, on matplotlib's Agg backend."""
    import matplotlib
    import matplotlib.pyplot as plt

    matplotlib.use("Agg")
    _, call = DEFERRED[name]
    arrays = mps_arrays(L=4)
    ft, fj = call(build(ttn, arrays)), call(build(jtn, arrays))
    try:
        assert _fig_signature(ft) == _fig_signature(fj)
        assert any(ax.lines or ax.collections for ax in ft.axes)
    finally:
        plt.close(ft)
        plt.close(fj)


def _target(pkg, tn):
    """``tn`` with its data squared: the same indices, another value."""
    out = tn.copy()
    out.apply_to_arrays(lambda x: x * x)
    return out


ONCE_DEFERRED = {
    "fit": lambda pkg, tn: tn.fit(_target(pkg, tn), steps=2),
    "distance": lambda pkg, tn: tn.distance(_target(pkg, tn)),
    "distance_normalized": lambda pkg, tn: tn.distance_normalized(
        _target(pkg, tn)),
    "tensor_distance": lambda pkg, tn: tn["I0"].distance(
        _target(pkg, tn)["I0"]),
    "aslinearoperator": lambda pkg, tn: tn.aslinearoperator(
        ["p0", "p1"], ["p2", "p3"]).to_dense(),
    "local_fit": lambda pkg, tn: tn.compress_between(
        "I1", "I2", mode="local-fit", max_bond=2, steps=2) or tn,
    "full_bond_fit": lambda pkg, tn: tn.compress_between(
        "I1", "I2", mode="full-bond", max_bond=2) or tn,
    "compress_all_1d": lambda pkg, tn: tn.compress_all_1d(max_bond=2),
}


@pytest.mark.parametrize("name", sorted(ONCE_DEFERRED))
def test_once_deferred_methods_match(name):
    """The eight methods that raised naming ROADMAP item 16 until the
    fitting and linear-operator modules were ported: each gives
    quimb_tpu's value (networks contracted to sorted outer indices;
    1e-10, as anything that passes through a split or a solve)."""
    call = ONCE_DEFERRED[name]
    t, j = both(mps_arrays(L=4))
    got, want = call(ttn, t), call(jtn, j)
    if isinstance(want, float):
        assert abs(got - want) <= 1e-12 * abs(want)
    else:
        _assert_close(got, want, rtol=SPLIT_TOL)


BP_GAUGES = {
    "mps": (lambda: mps_arrays(L=5), lambda tn: tn.gauge_all_belief_propagation(
        tol=1e-10)),
    "grid": (lambda: grid_arrays(), lambda tn: tn.gauge_all_belief_propagation(
        max_iterations=30)),
    "gauge_all bp": (lambda: grid_arrays(2, 2, seed=3), lambda tn: tn.gauge_all(
        method="bp", max_iterations=20)),
    "in place": (lambda: grid_arrays(1, 3, seed=4), lambda tn:
                 tn.gauge_all_belief_propagation_(damping=0.1) and tn),
}


@pytest.mark.parametrize("name", sorted(BP_GAUGES))
def test_gauge_all_belief_propagation_matches(name):
    """Once deferred to ROADMAP item 16(c): the 1-norm BP gauge gives
    quimb_tpu's tensors (the same tids, so one order of messages), and
    keeps the network's value (an exact contraction of a few hundred
    numbers: 1e-12)."""
    arrays, call = BP_GAUGES[name]
    t, j = both(arrays())
    value = _dense(t)
    gt, gj = call(t), call(j)
    for tid in gj.tensor_map:
        np.testing.assert_allclose(_np(gt.tensor_map[tid].data),
                                   _np(gj.tensor_map[tid].data),
                                   rtol=1e-10, atol=1e-12)
    _assert_close(gt, value, rtol=1e-12)


# the methods that were deferred until simplify.py and gating.py were
# ported: each now matches quimb_tpu (contracted value, and the number of
# tensors left) on an MPS with a diagonal, an anti-diagonal and a
# low-rank tensor hung on it
WIRED = {
    "rank_simplify": lambda tn, pkg: tn.rank_simplify(),
    "full_simplify": lambda tn, pkg: tn.full_simplify(seq="ADCRS"),
    "compress_simplify": lambda tn, pkg: tn.compress_simplify(max_bond=2),
    "diagonal_reduce": lambda tn, pkg: tn.diagonal_reduce(),
    "antidiag_gauge_": lambda tn, pkg: tn.antidiag_gauge_(),
    "gate_inds": lambda tn, pkg: tn.gate_inds(
        np.kron(np.eye(2), np.diag([1.0, -1.0])), ("p1", "p2"),
        contract="auto-split-gate"),
}


def _wired_network(pkg):
    rng = np.random.default_rng(4)
    arrays = mps_arrays(L=4, chi=3) + [
        (np.diag(rng.standard_normal(2)), ("p0", "q0"), {"D"}),
        (np.fliplr(np.diag(rng.standard_normal(2))).copy(), ("p3", "q3"),
         {"X"}),
        (np.einsum("a,b->ab", *rng.standard_normal((2, 2))), ("p1", "q1"),
         {"R"}),
    ]
    return build(pkg, arrays)


@pytest.mark.parametrize("name", sorted(WIRED))
def test_wired_methods_match_quimb_tpu(name):
    t, j = _wired_network(ttn), _wired_network(jtn)
    tr, jr = WIRED[name](t, ttn), WIRED[name](j, jtn)
    tr, jr = (t if tr is None else tr), (j if jr is None else jr)
    assert tr.num_tensors == jr.num_tensors
    _assert_close(tr, jr)
    if name in ("rank_simplify", "full_simplify", "antidiag_gauge_"):
        # the rewrites that keep the outer indices keep the value on them
        _assert_close(tr, _wired_network(jtn))


# -- devices, conversion, random arrays ------------------------------------------


def test_numpy_data_defaults_to_the_gpu():
    arr = np.ones((2, 3))
    if torch.cuda.is_available():
        assert ttn.Tensor(arr, inds="ab").data.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttn.Tensor(arr, inds="ab")
    # a torch tensor keeps its device; host arrays stay host under numpy
    assert ttn.Tensor(torch.ones(2, 3), inds="ab").data.device.type == "cpu"
    with tctr.contract_backend("numpy"):
        t = ttn.Tensor(arr, inds="ab")
        assert isinstance(t.data, np.ndarray)
        u = ttn.Tensor(np.ones((3, 4)), inds="bc")
        assert isinstance((t @ u).data, np.ndarray)
        tn = ttn.TensorNetwork([t, u])
        assert isinstance(tn.contract(...).data, np.ndarray)


def test_from_tpu_tensor_network():
    j = build(jtn, grid_arrays(dtype="complex128"))
    j.exponent = 0.5
    t = convert.from_tpu_tensor_network(j, device="cpu")
    assert [x.inds for x in t] == [x.inds for x in j]
    assert [set(x.tags) for x in t] == [set(x.tags) for x in j]
    assert t.exponent == 0.5
    _assert_close(t, j)
    one = convert.from_tpu_tensor(j.tensors[0], device="cpu")
    assert one.inds == j.tensors[0].inds and one.data.device.type == "cpu"


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128,
                                   torch.float32])
def test_randn_shape_dtype_determinism_moments(dtype):
    x = trand.randn((200, 300), dtype=dtype, seed=7, device="cpu")
    assert x.shape == (200, 300) and x.dtype == dtype
    assert x.device.type == "cpu"
    assert torch.equal(x, trand.randn((200, 300), dtype=dtype, seed=7,
                                      device="cpu"))
    assert not torch.equal(x, trand.randn((200, 300), dtype=dtype, seed=8,
                                          device="cpu"))
    v = x.to(torch.complex128) if dtype.is_complex else x.double()
    # 60000 draws: the mean within 5 standard errors of 0; each real
    # part has unit variance, as quimb_tpu's
    assert abs(v.mean().item()) < 5 * (2 / 60000) ** 0.5
    assert v.real.var().item() == pytest.approx(1.0, abs=0.03)
    if dtype.is_complex:
        assert v.imag.var().item() == pytest.approx(1.0, abs=0.03)
    trand.seed_rand(3)
    a = trand.randn(5, device="cpu")
    trand.seed_rand(3)
    assert torch.equal(a, trand.randn(5, device="cpu"))
    t = ttn.Tensor(torch.zeros(3, 4), inds="ab").randomize(seed=2)
    assert torch.equal(t.data, trand.randn((3, 4), dtype=torch.float32,
                                           seed=2, device="cpu"))


def test_copy_tensor_and_parametrized():
    c = ttn.COPY_tensor(3, ("a", "b", "c"), dtype="float64", device="cpu")
    j = jtn.COPY_tensor(3, ("a", "b", "c"), dtype="float64")
    _assert_close(c, j)
    pt = ttn.PTensor(lambda p: p * 2, torch.ones(2, 3), inds="ab")
    assert torch.equal(pt.data, 2 * torch.ones(2, 3))
    assert isinstance(pt.unparametrize(), ttn.Tensor)


def _surgery(pkg, tn):
    """The network-surgery methods of the parity layer, each on a copy."""
    out = {}
    t = tn.copy()
    t.vector_reduce_("p0", np.array([0.3, -1.2]))
    out["vector_reduce"] = t
    out["sum_reduce"] = tn.sum_reduce("p1")
    t = tn.copy()
    t.cut_between("I1", "I2", "cl", "cr")
    out["cut_between"] = t
    t = tn.copy()
    t.new_bond("I0", "I3", size=1)
    out["new_bond"] = t
    if pkg is ttn:
        t = tn.copy()
        t.reduce_inds_onto_bond("p1", "p2", ndim_cutoff=2)
        out["reduce_inds_onto_bond"] = t
    t = tn.copy()
    t.drape_bond_between("I1", "I2", "I4", inplace=True)
    out["drape_bond_between"] = t
    out["combine"] = tn.combine(tn.H.reindex(
        {f"p{i}": f"q{i}" for i in range(6)}))
    out["insert_into"] = tn.insert_compressor_between_regions(
        ["I0", "I1"], ["I2"], max_bond=2, cutoff=0.0,
        insert_into=tn.copy())
    out["reduced_factor"] = pkg.Tensor(
        tn.compute_reduced_factor("right", ("p0", "p1"), ("p2",)),
        inds=("r", "p2"))
    t1, t2 = tn["I2"].copy(), tn["I3"].copy()
    pkg.tensor_fuse_squeeze(t1, t2)
    out["tensor_fuse_squeeze"] = pkg.TensorNetwork([t1, t2])
    a, b = tn["I0"].copy(), tn["I5"].copy()
    pkg.connect(a, b, 0, 1)
    out["connect"] = pkg.TensorNetwork([a, b])
    t = tn.copy()
    t.isometrize_(method="qr", allow_no_left_inds=True)
    out["isometrize_skip"] = t
    out["gate_inds_with_tn"] = tn.gate_inds_with_tn(
        ("p0",), pkg.TensorNetwork([pkg.Tensor(
            (torch.as_tensor if pkg is ttn else np.asarray)(
                np.array([[0.0, 1.0], [1.0, 0.0]])), inds=("gi", "go"))]),
        ("gi",), ("go",))
    out["select_path_free"] = tn.select_local("I2", max_distance=2)
    out["flip"] = tn.flip("p3")
    return out


@pytest.mark.parametrize("name", [
    "vector_reduce", "sum_reduce", "cut_between", "new_bond",
    "reduce_inds_onto_bond", "drape_bond_between", "combine",
    "insert_into", "reduced_factor", "tensor_fuse_squeeze", "connect",
    "isometrize_skip", "gate_inds_with_tn", "select_path_free", "flip",
])
def test_network_surgery_matches_quimb_tpu(name):
    t, j = both(mps_arrays(chi=3, dtype="complex128"))
    rt = _surgery(ttn, t)[name]
    if name == "reduce_inds_onto_bond":
        # quimb_tpu raises KeyError here (it reads the reduced indices'
        # sizes from the network after removing them); the port's QR
        # reduction must keep the network's value
        with pytest.raises(KeyError):
            j.copy().reduce_inds_onto_bond("p1", "p2", ndim_cutoff=2)
        assert rt.num_tensors == 7
        _assert_close(rt, j, rtol=SPLIT_TOL)
        return
    rj = _surgery(jtn, j)[name]
    if name in ("cut_between", "connect", "combine", "gate_inds_with_tn"):
        # fresh index names differ between the packages: compare values
        # on the outer indices both share
        assert len(rt.outer_inds()) == len(rj.outer_inds())
        rt = rt.reindex({ix: f"o{n}" for n, ix in enumerate(
            sorted(rt.outer_inds(), key=_shared_order(rt)))})
        rj = rj.reindex({ix: f"o{n}" for n, ix in enumerate(
            sorted(rj.outer_inds(), key=_shared_order(rj)))})
    tol = SPLIT_TOL if name in ("reduce_inds_onto_bond", "insert_into",
                                "reduced_factor") else RTOL
    _assert_close(rt, rj, rtol=tol)


def _shared_order(tn):
    """Sort key of outer indices: named ones by name, fresh ones after,
    by their tensor's tags and position."""
    def key(ix):
        if not ix.startswith("_"):
            return (0, ix, 0)
        (tid,) = tn.ind_map[ix]
        t = tn.tensor_map[tid]
        return (1, str(sorted(t.tags)), t.inds.index(ix))
    return key


STRUCTURE = {
    "get_equation": lambda tn: tn.get_equation(),
    "get_hyperinds": lambda tn: tn.get_hyperinds(),
    "get_multibonds": lambda tn: sorted(map(sorted, tn.get_multibonds()
                                            .values())),
    "outer_dims_inds": lambda tn: tn.outer_dims_inds(),
    "outer_size": lambda tn: tn.outer_size(),
    "tensors_sorted": lambda tn: [t.inds for t in tn.tensors_sorted()],
    "compute_contracted_inds": lambda tn: tn.compute_contracted_inds(
        "t0", "t1"),
    "inputs_output_size_dict": lambda tn: tn.get_inputs_output_size_dict(),
    "tags": lambda tn: sorted(tn.tags),
    "num_tensors_indices": lambda tn: (tn.num_tensors, tn.num_indices),
    "bond": lambda tn: tn.bond("I0", "I1"),
    "iscomplex": lambda tn: tn.iscomplex(),
    "tid_neighbors": lambda tn: {k: sorted(v) for k, v in
                                 tn.get_tid_neighbor_map().items()},
    "subgraphs_after_delete": lambda tn: len(
        _deleted(tn, "I2").subgraphs()),
    "partition_tensors": lambda tn: len(tn.partition_tensors("I1")[1]),
    "shortest_distances": lambda tn: sorted(
        tn.compute_shortest_distances().items()),
}


def _deleted(tn, tag):
    tn = tn.copy()
    tn.delete(tag)
    return tn


@pytest.mark.parametrize("name", sorted(STRUCTURE))
def test_structure_queries_match_quimb_tpu(name):
    t, j = both(mps_arrays(chi=3, dtype="complex128"))
    assert STRUCTURE[name](t) == STRUCTURE[name](j)


def test_item_strip_exponent_setitem_and_consecutive_tids():
    t, j = both(mps_arrays(L=3, chi=2))
    full_t = t.contract(..., output_inds=())
    assert ttn.TensorNetwork([ttn.Tensor(full_t, inds=())]).item() == \
        pytest.approx(float(_np(full_t)), rel=RTOL)
    for tn in (t, j):
        tn.strip_exponent("t0")
    assert t.exponent == pytest.approx(j.exponent, rel=RTOL)
    _assert_close(t, j)
    new = ttn.Tensor(torch.ones(2, 2, dtype=torch.float64),
                     inds=("p0", "k1"), tags="I0")
    t["I0"] = new
    assert t["I0"] is new
    del t["I2"]
    assert t.num_tensors == 2
    t.make_tids_consecutive()
    assert set(t.tensor_map) == {0, 1}
    z = t.copy()
    z.convert_to_zero()
    assert all(float(abs(x.data).sum()) == 0.0 for x in z)
    r1 = t.randomize(seed=3)
    r2 = t.randomize(seed=3)
    assert all(torch.equal(a.data, b.data) for a, b in zip(r1, r2))
