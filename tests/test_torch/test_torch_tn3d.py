"""quimb_torch's 3D layer (``tensor/tn3d/core.py``: ``TensorNetwork3D``,
``PEPS3D`` and the parity methods) against quimb_tpu's, in float64 on the
CPU.

A network is built in quimb_tpu (a numpy fill function, or its 3D Ising
builder) and carried across by ``convert.from_tpu_tn3d``, so both packages
hold the same arrays, index names and tags; quimb_tpu's side runs on host
arrays inside its ``contract_backend("numpy")``. A contraction of a few
hundred O(1) numbers agrees to 1e-12 relative; a truncated boundary
contraction takes the same splits in both packages (the spectra at these
sizes have no degenerate pair at the cut), so 1e-10 relative.
"""

import itertools

import numpy as np
import pytest
import torch

import quimb_tpu.tensor as jtn
import quimb_torch.tensor as ttn
from quimb_torch import convert
from quimb_torch.tensor.tn3d import core as t3
from quimb_tpu.ops.contraction import contract_backend as jbackend

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


def _ising(L, h=0.0, j=1.0, cyclic=False):
    """quimb_tpu's direct 3D Ising network (host arrays) and the port's
    copy of it."""
    jt = _host(jtn.TN3D_classical_ising_partition_function(
        *L, beta=BETA, h=h, j=j, cyclic=cyclic))
    return jt, convert.from_tpu_tn3d(jt, device=CPU)


def _fill(seed):
    rng = np.random.default_rng(seed)
    return lambda shape: rng.normal(size=shape)


def _peps(L=(2, 2, 2), D=2, seed=0):
    j = jtn.PEPS3D.from_fill_fn(_fill(seed), *L, D)
    j = _host(j)
    return j, convert.from_tpu_tn3d(j, device=CPU)


def _c(x):
    """A scalar result (a number, a 0-d array or a 0-d Tensor) as a
    complex number."""
    return complex(x.data if hasattr(x, "inds") else x)


def _rel(a, b):
    a, b = _c(a), _c(b)
    return abs(a - b) / abs(b)


def _ising_brute(L, beta, j=1.0, h=0.0):
    coos = list(itertools.product(*map(range, L)))
    edges = list(t3.gen_3d_bonds(*L))
    z = 0.0
    for spins in itertools.product((1, -1), repeat=len(coos)):
        s = dict(zip(coos, spins))
        e = j * sum(s[a] * s[b] for a, b in edges) + h * sum(spins)
        z += np.exp(beta * e)
    return z


# -- structure ---------------------------------------------------------------


@pytest.mark.parametrize("L", [(2, 3, 4), (3, 1, 2)])
def test_gen_3d_bonds_matches(L):
    assert list(t3.gen_3d_bonds(*L)) == list(
        jtn.tn3d.core.gen_3d_bonds(*L))
    keep = lambda i, j, k: (i + j + k) % 2 == 0  # noqa: E731
    assert list(t3.gen_3d_bonds(*L, coo_filter=keep)) == list(
        jtn.tn3d.core.gen_3d_bonds(*L, coo_filter=keep))


@pytest.mark.parametrize("optimize", [None, "greedy", "optimal"])
def test_peps3d_from_fill_fn_matches(optimize):
    """Every element of the port's dense state against quimb_tpu's, at
    ``rtol=1e-12`` beside ``atol = 1e-12 * max|x|``. The 12-tensor network
    takes its default path from a random-greedy search that stops on the
    wall clock, so the two packages may contract in different orders: a
    change of order moves an element by a few 1e-12 of its own size where
    it is 1e-5 of the largest, but never by more than about 1e-15 of the
    largest. The bound holds on the default path and on ``"greedy"`` and
    ``"optimal"``."""
    j, t = _peps((2, 3, 2), D=3, seed=1)
    own = ttn.PEPS3D.from_fill_fn(_fill(1), 2, 3, 2, 3, device=CPU)
    assert (own.Lx, own.Ly, own.Lz) == (2, 3, 2)
    assert own.site_inds == j.site_inds == t.site_inds
    for coo in itertools.product(range(2), range(3), range(2)):
        tag = j.site_tag(*coo)
        np.testing.assert_array_equal(own[tag].data.numpy(),
                                      np.asarray(j[tag].data))
        assert own[tag].tags == t[tag].tags
        assert own.phys_dim(*coo) == 2
    assert own.max_bond() == 3
    opts = {} if optimize is None else {"optimize": optimize}
    x = own.to_dense(**opts).numpy()
    ref = np.asarray(j.to_dense())
    np.testing.assert_allclose(x, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


def test_peps3d_rand_ones_empty():
    p = ttn.PEPS3D.rand(2, 2, 1, 3, seed=5, device=CPU)
    q = ttn.PEPS3D.rand(2, 2, 1, 3, seed=5, device=CPU)
    assert p.dtype == torch.float64 and p.max_bond() == 3
    for coo in p.gen_site_coos():
        tag = p.site_tag(*coo)
        np.testing.assert_array_equal(p[tag].data, q[tag].data)
    one = ttn.PEPS3D.ones(2, 1, 2, 2, device=CPU)
    assert all(bool((t.data == 1).all()) for t in one)
    zero = ttn.PEPS3D.empty(2, 1, 2, 2, device=CPU)
    assert all(bool((t.data == 0).all()) for t in zero)
    assert complex(one.make_norm().contract(...)) == pytest.approx(
        complex(jtn.PEPS3D.ones(2, 1, 2, 2).make_norm().contract(...)),
        rel=1e-12)


def test_tags_ranges_and_cyclicity():
    j, t = _ising((2, 3, 3))
    assert (t.x_tags, t.y_tags, t.z_tags) == (j.x_tags, j.y_tags, j.z_tags)
    assert (t.x_tag_id, t.y_tag_id, t.z_tag_id) == ("X{}", "Y{}", "Z{}")
    assert t.nsites == j.nsites == 18
    assert list(t.gen_bond_coos()) == list(j.gen_bond_coos())
    assert t.valid_coo((1, 2, 2)) and not t.valid_coo((2, 0, 0))
    assert not t.valid_coo((1, 1, 1), xrange=(0, 0))
    assert t.has_site((1, 1, 1)) == j.has_site((1, 1, 1))
    assert t.maybe_convert_coo((1, 0, 2)) == "I1,0,2"
    t.select(t.site_tag(0, 0, 0)).tensor_map.clear()
    assert t.get_ranges_present() == ((0, 1), (0, 2), (0, 2))
    for axis in "xyz":
        assert getattr(t, f"is_cyclic_{axis}")() == \
            getattr(j, f"is_cyclic_{axis}")()
    _, c = _ising((3, 3, 3), cyclic=True)
    assert c.is_cyclic_x() and c.is_cyclic_y() and c.is_cyclic_z()


@pytest.mark.parametrize("opts", [
    {},
    dict(xreverse=True, stepping_order="zx"),
    dict(xrange=(0, 1), yrange=(1, 2), coordinate_order="zyx"),
    dict(zrange=(1, 1), coordinate_order="xy", step_only=1),
    dict(ystep=-1, yreverse=True),
])
def test_gen_pairs_matches(opts):
    j, t = _ising((2, 3, 3))
    assert list(t.gen_pairs(**opts)) == list(j.gen_pairs(**opts))


def test_gen_pairs_rejects_a_missing_axis_of_size_two():
    _, t = _ising((2, 2, 2))
    with pytest.raises(ValueError, match="coordinate_order"):
        list(t.gen_pairs(coordinate_order="xy"))


# -- exact values and boundary contractions ----------------------------------


@pytest.mark.parametrize("h, j", [(0.0, 1.0), (0.3, -0.7)])
def test_ising_exact_matches_brute_force(h, j):
    jt, t = _ising((2, 2, 2), h=h, j=j)
    own = ttn.TN3D_classical_ising_partition_function(
        2, 2, 2, beta=BETA, h=h, j=j, device=CPU)
    z = _c(t.contract(...))
    assert _rel(z, jt.contract(...)) < 1e-12
    assert _rel(own.contract(...), z) < 1e-12
    assert z.real == pytest.approx(_ising_brute((2, 2, 2), BETA, j, h),
                                   rel=1e-12)


CONTRACTIONS = {
    "x sweep": lambda tn: tn.contract_boundary(max_bond=4),
    "x sweep exact": lambda tn: tn.contract_boundary(),
    "faces": lambda tn: tn.contract_boundary(
        max_bond=4, sequence=("zmin", "xmax", "ymin")),
    "ctmrg": lambda tn: tn.contract_ctmrg(max_bond=4),
    "ctmrg default bond": lambda tn: tn.contract_ctmrg(),
    "hotrg": lambda tn: tn.contract_hotrg(max_bond=4),
    "hotrg no equalize": lambda tn: tn.contract_hotrg(
        max_bond=3, equalize_norms=False),
    "peps sweep": lambda tn: tn.contract_peps_sweep(max_bond=4,
                                                    direction="ymax"),
    "simple sweep": lambda tn: tn.contract_simple_sweep(max_bond=4),
    "from zmin": lambda tn: tn.contract_boundary_from(
        "zmin", max_bond=4).contract(...),
    "from xmax, range": lambda tn: tn.contract_boundary_from(
        "xmax", max_bond=3, xrange=(1, 2)).contract(...),
    "coarse grain y": lambda tn: tn.coarse_grain_hotrg(
        "y", max_bond=3).contract(...),
    "flatten": lambda tn: tn.flatten().contract(...),
}


@pytest.mark.parametrize("name", sorted(CONTRACTIONS))
def test_contractions_match(name):
    jt, t = _ising((3, 3, 3), h=0.05)
    call = CONTRACTIONS[name]
    assert _rel(call(t), call(jt)) < REL


def test_in_place_forms_match():
    jt, t = _ising((2, 3, 3))
    for name, kw in (("contract_boundary_", dict(max_bond=3)),
                     ("contract_ctmrg_", dict(max_bond=3)),
                     ("contract_hotrg_", dict(max_bond=3))):
        a = getattr(t.copy(), name)(**kw)
        b = getattr(jt.copy(), name)(**kw)
        assert _rel(a, b) < REL
    tt, jj = t.copy(), jt.copy()
    tt.coarse_grain_hotrg_("z", max_bond=3)
    jj.coarse_grain_hotrg_("z", max_bond=3)
    assert tt.Lz == jj.Lz == 2
    assert _rel(tt.contract(...), jj.contract(...)) < REL
    tt.contract_boundary_from_("xmin", max_bond=3)
    jj.contract_boundary_from_("xmin", max_bond=3)
    assert tt.num_tensors == jj.num_tensors
    tt.flatten_()
    assert _rel(tt.contract(...), jj.contract(...)) < REL


@pytest.mark.parametrize("method", ["canonize", "compress"])
def test_plane_sweeps_match(method):
    jt, t = _ising((2, 3, 3), h=0.1)
    if method == "canonize":
        kw = dict(xrange=(0, 0))
        t.canonize_plane(**kw)
        jt.canonize_plane(**kw)
    else:
        kw = dict(yrange=(0, 1), max_bond=1, cutoff=0.0)
        t.compress_plane(**kw)
        jt.compress_plane(**kw)
    for coo in t.gen_site_coos():
        tag = t.site_tag(*coo)
        assert t[tag].shape == jt[tag].shape
    assert _rel(t.contract(...), jt.contract(...)) < REL


def test_plane_compression_skips_what_quimb_tpu_skips():
    """A site missing from the network and a site of two layers are left
    as quimb_tpu leaves them (it catches the errors of compress_between);
    the port checks the structure instead."""
    j, t = _peps((2, 2, 2), D=2, seed=3)
    nj, nt = j.make_norm(), t.make_norm()
    # every site holds a ket and a bra tensor: nothing to compress
    before = [x.shape for x in nt]
    nt.compress_plane(max_bond=1)
    assert [x.shape for x in nt] == before
    # one site gone: its neighbours' bonds are left as they are
    for tn in (nt, nj):
        tn.contract_tags_(tn.site_tag(1, 0, 0), which="any")
        tn.contract_tags_(tn.site_tag(1, 0, 1), which="any")
        tid, = tn.tag_map[tn.site_tag(1, 1, 1)] & tn.tag_map["KET"]
        tn.pop_tensor(tid)
    nt.compress_plane(xrange=(1, 1), max_bond=2)
    nj.compress_plane(xrange=(1, 1), max_bond=2)
    assert sorted(x.shape for x in nt) == sorted(x.shape for x in nj)


def test_a_failing_split_reaches_the_caller(monkeypatch):
    """quimb_tpu swallows a ValueError of any bond compression; in the
    port a split's own error propagates."""
    _, t = _ising((2, 2, 2))
    from quimb_torch.tensor import core as tcore

    def broken(*args, **kwargs):
        raise ValueError("split failed")

    monkeypatch.setattr(tcore, "tensor_compress_bond", broken)
    with pytest.raises(ValueError, match="split failed"):
        t.contract_ctmrg(max_bond=2)


# -- vectors ------------------------------------------------------------------


def test_norm_and_dense_match():
    j, t = _peps((2, 2, 2), D=2, seed=4)
    assert _rel(t.norm2(max_bond=4), j.norm2(max_bond=4)) < REL
    assert _rel(t.norm2(), j.norm2()) < REL
    assert _rel(t.make_norm().contract(...),
                j.make_norm().contract(...)) < 1e-12
    ref = np.asarray(j.to_dense())
    np.testing.assert_allclose(t.to_dense().numpy(), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


def test_gate_and_local_expectation_match():
    j, t = _peps((2, 2, 2), D=2, seed=5)
    rng = np.random.default_rng(6)
    X = rng.normal(size=(4, 4))
    G = X + X.T
    where = ((0, 0, 0), (0, 0, 1))
    for contract in (True, "reduce-split", "split"):
        a = t.gate(G, where, contract=contract)
        b = j.gate(G, where, contract=contract)
        np.testing.assert_allclose(a.to_dense().numpy(),
                                   np.asarray(b.to_dense()), atol=1e-12)
    g = t.copy()
    g.gate_(G[:2, :2], (1, 1, 1))
    np.testing.assert_allclose(
        g.to_dense().numpy(),
        np.asarray(j.gate(G[:2, :2], (1, 1, 1)).to_dense()), atol=1e-12)
    terms = {where: G, ((0, 1, 1), (1, 1, 1)): G}
    for normalized in (True, False):
        a = t.compute_local_expectation(terms, max_bond=4,
                                        normalized=normalized)
        b = j.compute_local_expectation(terms, max_bond=4,
                                        normalized=normalized)
        assert _rel(a, b) < REL
    allt = t.compute_local_expectation(terms, return_all=True)
    assert set(allt) == set(terms)


@pytest.mark.parametrize("method", ["exact", "cluster"])
def test_partial_trace_matches(method):
    j, t = _peps((2, 2, 1), D=2, seed=7)
    for keep in ((0, 1, 0), [(0, 0, 0), (1, 1, 0)]):
        a = t.partial_trace(keep, method=method).numpy()
        b = np.asarray(j.partial_trace(keep, method=method))
        np.testing.assert_allclose(a, b, atol=1e-12)
        assert a.trace() == pytest.approx(1.0, abs=1e-12)
    a = t.partial_trace_cluster([(1, 0, 0)], max_distance=2).numpy()
    b = np.asarray(j.partial_trace_cluster([(1, 0, 0)], max_distance=2))
    np.testing.assert_allclose(a, b, atol=1e-12)


def test_permute_and_reindex_match():
    j, t = _peps((2, 2, 2), D=2, seed=8)
    for shape in ("xyzXYZp", "pZYXzyx"):
        a, b = t.copy().permute_arrays(shape), j.copy().permute_arrays(shape)
        for coo in t.gen_site_coos():
            tag = t.site_tag(*coo)
            assert a[tag].inds == b[tag].inds
            np.testing.assert_array_equal(a[tag].data.numpy(),
                                          np.asarray(b[tag].data))
    r = t.reindex_sites("q{},{},{}")
    assert "q1,0,1" in r.ind_map and "k1,0,1" not in r.ind_map
    r2 = t.copy()
    r2.reindex_sites_("q{},{},{}", where=[(0, 0, 0)])
    assert "q0,0,0" in r2.ind_map and "k1,1,1" in r2.ind_map


def test_convert_keeps_class_and_ids():
    j, t = _ising((2, 2, 3))
    assert type(t).__name__ == "TensorNetwork3D"
    assert (t.Lx, t.Ly, t.Lz) == (2, 2, 3)
    assert [x.inds for x in t] == [x.inds for x in j]
    _, p = _peps((1, 2, 2))
    assert isinstance(p, ttn.PEPS3D) and p.site_ind(0, 1, 1) == "k0,1,1"
