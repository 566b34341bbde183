"""quimb_torch's network builders (``tensor/tensor_builder.py``) against
quimb_tpu's, in float64 on the CPU.

quimb_tpu's random builders draw from JAX's generator, which torch cannot
reproduce, so both modules' ``get_rand_fill_fn`` are replaced by one
numpy factory (``numpy_fills``) where values are compared; the builders
that draw their structure from ``np.random.default_rng`` (rewiring, random
trees, hyper networks, k-SAT instances) draw the same structure in both
packages. Networks are compared by their contracted values (a few hundred
O(1) numbers: 1e-12 relative) and by their index sizes and tags.
"""

import itertools

import numpy as np
import pytest
import torch

import quimb_tpu.tensor as jtn
import quimb_torch.tensor as ttn
from quimb_torch.tensor import tensor_builder as tb
from quimb_tpu.ops.contraction import contract_backend as jbackend
from quimb_tpu.tensor import tensor_builder as jb

CPU = "cpu"
BETA = 0.3


@pytest.fixture(autouse=True)
def _one_thread_host_reference():
    """One torch thread, and quimb_tpu on host numpy arrays."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with jbackend("numpy"):
        yield
    torch.set_num_threads(n)


@pytest.fixture
def numpy_fills(monkeypatch):
    """Both packages' random builders draw from numpy: a fill function of
    one ``default_rng(seed)`` stream, normal with ``loc`` and ``scale``."""
    def get_rand_fill_fn(dist="normal", loc=0.0, scale=1.0, seed=None,
                         dtype=None, device=None):
        rng = np.random.default_rng(seed)
        return lambda shape=(): loc + scale * rng.normal(size=shape)

    monkeypatch.setattr(tb, "get_rand_fill_fn", get_rand_fill_fn)
    monkeypatch.setattr(jb, "get_rand_fill_fn", get_rand_fill_fn)


def _fill(seed):
    rng = np.random.default_rng(seed)
    return lambda shape: rng.normal(size=shape)


def _z(tn):
    x = tn.contract(..., output_inds=())
    return complex(x.data if hasattr(x, "inds") else x)


def _same_value(t, j, rel=1e-12):
    assert _z(t) == pytest.approx(_z(j), rel=rel)


def _sizes(tn):
    """Each tensor's index sizes and tags, in order, with the index names
    of rand_uuid left out."""
    return [(tuple(x.shape), tuple(sorted(x.tags))) for x in tn]


# -- random tensors ------------------------------------------------------------


def test_delta_array_matches():
    for shape in ((2, 2, 2), (3, 3)):
        np.testing.assert_array_equal(tb.delta_array(shape),
                                      jb.delta_array(shape))


def test_rand_tensors():
    t = ttn.rand_tensor((2, 3), inds=("a", "b"), tags="T", seed=3,
                        device=CPU)
    u = ttn.rand_tensor((2, 3), inds=("a", "b"), seed=3, device=CPU)
    assert t.shape == (2, 3) and t.tags == {"T"} and t.dtype == torch.float64
    np.testing.assert_array_equal(t.data, u.data)
    p = ttn.rand_phased((4, 5), inds=("a", "b"), seed=1, device=CPU)
    np.testing.assert_allclose(p.data.abs().numpy(), 1.0, atol=1e-15)
    assert complex((p.H @ p)) == pytest.approx(20.0, rel=1e-14)
    s = ttn.rand_tensor_symmetric(3, inds=("a", "b", "c"), seed=2,
                                  device=CPU).data.numpy()
    for perm in itertools.permutations(range(3)):
        np.testing.assert_array_equal(s, s.transpose(perm))


def test_rand_symmetric_array_matches():
    got = tb.rand_symmetric_array(3, 3, fill_fn=_fill(5))
    want = jb.rand_symmetric_array(3, 3, fill_fn=_fill(5))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_rand_fill_fn_streams():
    from quimb_torch.gen.rand import get_rand_fill_fn

    a = get_rand_fill_fn(seed=4, dtype="float64", device=CPU)
    b = get_rand_fill_fn(seed=4, dtype="float64", device=CPU)
    x1, x2 = a((2, 2)), a((2, 2))
    assert not torch.equal(x1, x2)
    torch.testing.assert_close(b((2, 2)), x1, rtol=0, atol=0)
    c = get_rand_fill_fn(dist="uniform", loc=1.0, scale=2.0,
                         dtype="complex128", device=CPU)((1000,))
    assert c.dtype == torch.complex128
    assert float(c.real.min()) >= 0.0 and float(c.real.max()) <= 2.0


# -- site / edge / string factories ------------------------------------------


def test_product_and_computational_states_match():
    sites = {(0, 1): "0", (1, 0): "+", (1, 1): "-", (0, 0): "1"}
    t = ttn.TN_from_sites_computational_state(sites, device=CPU)
    j = jtn.TN_from_sites_computational_state(sites)
    assert t.sites == j.sites and t.site_inds == j.site_inds
    np.testing.assert_allclose(t.to_dense().numpy(), np.asarray(j.to_dense()),
                               atol=1e-15)
    vecs = {s: np.array([0.6, 0.8]) for s in range(3)}
    t = ttn.TN_from_sites_product_state(vecs, device=CPU)
    j = jtn.TN_from_sites_product_state(vecs)
    np.testing.assert_allclose(t.to_dense().numpy(), np.asarray(j.to_dense()),
                               atol=1e-15)


def test_edge_helpers_match():
    edges = [(1, 0), (0, 1), (2, 1), (1, 2), (0, 2)]
    assert list(tb.gen_unique_edges(edges)) == list(
        jb.gen_unique_edges(edges))
    strings = [((0, 0), (0, 1), (1, 1)), ((1, 1), (0, 1))]
    assert dict(tb.compute_string_edge_frequencies(strings)) == dict(
        jb.compute_string_edge_frequencies(strings))


def test_edges_with_value_and_tree_match():
    edges = ttn.edges_2d_square(2, 3)
    t = ttn.TN_from_edges_with_value(0.5, edges, 2, phys_dim=2, device=CPU)
    j = jtn.TN_from_edges_with_value(0.5, edges, 2, phys_dim=2)
    assert _sizes(t) == _sizes(j)
    _same_value(t.make_norm(), j.make_norm())
    tree = ttn.TN_rand_tree(7, 2, phys_dim=2, seed=4, max_degree=3,
                            device=CPU)
    jtree = jtn.TN_rand_tree(7, 2, phys_dim=2, seed=4, max_degree=3)
    assert _sizes(tree) == _sizes(jtree)


@pytest.mark.parametrize("kw", [
    {},
    dict(allow_plaquettes=False),
    dict(random_rewire=True, random_rewire_seed=3, join=True),
    dict(join="all", contract_sites=False),
    dict(normalize=True),
    dict(fuse_multibonds=False, line_dim=3),
])
def test_tn_from_strings_matches(kw):
    strings = [((0, 0), (0, 1), (1, 1), (1, 0), (0, 0)),
               ((0, 0), (0, 1)), ((1, 1), (1, 0)), ((0, 1), (1, 1))]
    t = ttn.TN_from_strings(strings, fill_fn=_fill(2), device=CPU, **kw)
    j = jtn.TN_from_strings(strings, fill_fn=_fill(2), **kw)
    assert t.sites == j.sites
    assert _sizes(t) == _sizes(j)
    _same_value(t, j)
    if kw.get("normalize"):
        assert _z(t) == pytest.approx(1.0, rel=1e-12)


@pytest.mark.parametrize("kw", [
    dict(n=6, reg=3),
    dict(n=8, reg=2, n_out=2, n_hyper_in=1, n_hyper_out=1, d_max=4),
])
def test_htn_rand_structure_matches(kw):
    t = ttn.HTN_rand(seed=9, device=CPU, **kw)
    j = jtn.HTN_rand(seed=9, **kw)
    assert [x.inds for x in t] == [x.inds for x in j]
    assert [x.shape for x in t] == [x.shape for x in j]


def test_cp_and_dual_builders_match():
    inds, sizes = ("a", "b", "c"), (2, 3, 2)
    t = ttn.HTN_CP_from_inds_and_fill_fn(_fill(1), inds, sizes, 3,
                                         bond_ind="h", device=CPU)
    j = jtn.HTN_CP_from_inds_and_fill_fn(_fill(1), inds, sizes, 3,
                                         bond_ind="h")
    np.testing.assert_allclose(
        t.contract(..., output_inds=inds).data.numpy(),
        np.asarray(j.contract(..., output_inds=inds).data), atol=1e-13)
    t = ttn.HTN_CP_from_sites_and_fill_fn(_fill(2), range(3), 2,
                                          device=CPU)
    j = jtn.HTN_CP_from_sites_and_fill_fn(_fill(2), range(3), 2)
    np.testing.assert_allclose(t.to_dense().numpy(), np.asarray(j.to_dense()),
                               atol=1e-13)
    rng = np.random.default_rng(3)
    seqs = [[rng.normal(size=(2, 2)) for _ in range(3)] for _ in range(2)]
    up, lo = ("u0", "u1", "u2"), ("l0", "l1", "l2")
    t = ttn.HTN_CP_operator_from_products(seqs, up, lo, tags_all="OP",
                                          device=CPU)
    j = jtn.HTN_CP_operator_from_products(seqs, up, lo, tags_all="OP")
    out = up + lo
    np.testing.assert_allclose(
        t.contract(..., output_inds=out).data.numpy(),
        np.asarray(j.contract(..., output_inds=out).data), atol=1e-13)
    assert "OP" in t.tags
    edges = ttn.edges_2d_square(2, 2)
    for phys_dim in (None, 2):
        t = ttn.HTN_dual_from_edges_and_fill_fn(_fill(4), edges, 2,
                                                phys_dim=phys_dim,
                                                device=CPU)
        j = jtn.HTN_dual_from_edges_and_fill_fn(_fill(4), edges, 2,
                                                phys_dim=phys_dim)
        assert type(t).__name__ == type(j).__name__
        assert _sizes(t) == _sizes(j)
        if phys_dim:
            np.testing.assert_allclose(t.to_dense().numpy(),
                                       np.asarray(j.to_dense()), atol=1e-12)
        else:
            _same_value(t, j)


def test_tn_matching_matches():
    edges = ttn.edges_2d_square(2, 2)
    j = jtn.TN_from_edges_and_fill_fn(_fill(5), edges, 2, phys_dim=2)
    from quimb_torch import convert

    t = convert.from_tpu_tngen(j, device=CPU)
    mt = ttn.TN_matching(t, 3, fill_fn=_fill(6))
    mj = jtn.TN_matching(j, 3, fill_fn=_fill(6))
    assert type(mt).__name__ == type(mj).__name__
    assert _sizes(mt) == _sizes(mj)
    np.testing.assert_allclose(mt.to_dense().numpy(),
                               np.asarray(mj.to_dense()), atol=1e-12)
    drawn = ttn.TN_matching(t, 2)
    assert drawn.dtype == t.dtype and set(drawn.outer_inds()) == set(
        t.outer_inds())


# -- lattices --------------------------------------------------------------------


LATTICE_2D = {
    "fill": lambda pkg, **kw: pkg.TN2D_from_fill_fn(
        _fill(1), 2, 3, 2, **kw),
    "fill cyclic": lambda pkg, **kw: pkg.TN2D_from_fill_fn(
        _fill(1), 3, 3, 2, cyclic=(True, False), **kw),
    "empty": lambda pkg, **kw: pkg.TN2D_empty(2, 2, 2, **kw),
    "value": lambda pkg, **kw: pkg.TN2D_with_value(0.7, 2, 3, 2, **kw),
    "rand": lambda pkg, **kw: pkg.TN2D_rand(2, 3, 2, seed=2, **kw),
    "symmetric": lambda pkg, **kw: pkg.TN2D_rand_symmetric(
        2, 2, 2, seed=3, **kw),
    "cdl": lambda pkg, **kw: pkg.TN2D_corner_double_line(3, 3, **kw),
    "hidden loop": lambda pkg, **kw: pkg.TN2D_rand_hidden_loop(
        2, 3, seed=4, **kw),
    "fill 3d": lambda pkg, **kw: pkg.TN3D_from_fill_fn(
        _fill(1), 2, 2, 2, 2, **kw),
    "fill 3d cyclic": lambda pkg, **kw: pkg.TN3D_from_fill_fn(
        _fill(1), 3, 2, 2, 2, cyclic=True, **kw),
    "empty 3d": lambda pkg, **kw: pkg.TN3D_empty(2, 2, 1, 2, **kw),
    "value 3d": lambda pkg, **kw: pkg.TN3D_with_value(
        0.6, 2, 2, 2, 2, **kw),
    "rand 3d": lambda pkg, **kw: pkg.TN3D_rand(2, 2, 2, 2, seed=5, **kw),
    "cdl 3d": lambda pkg, **kw: pkg.TN3D_corner_double_line(
        2, 2, 2, tiling=1, **kw),
    "hidden loop 3d": lambda pkg, **kw: pkg.TN3D_rand_hidden_loop(
        2, 2, 2, seed=6, line_density=1, **kw),
}


@pytest.mark.parametrize("name", sorted(LATTICE_2D))
def test_lattice_builders_match(name, numpy_fills):
    t = LATTICE_2D[name](ttn, device=CPU)
    j = LATTICE_2D[name](jtn)
    assert type(t).__name__ == type(j).__name__
    assert (t.Lx, t.Ly) == (j.Lx, j.Ly)
    assert _sizes(t) == _sizes(j)
    if all(float(x.data.abs().max()) == 0 for x in t):
        return
    _same_value(t, j)


def test_corner_double_line_counts_plaquettes():
    """With identity lines the CDL network contracts to line_dim to the
    number of closed loops (reference arXiv:1412.0732)."""
    eye = lambda shape: np.eye(*shape) if len(shape) == 2 \
        else np.ones(shape)  # noqa: E731
    t = ttn.TN2D_corner_double_line(3, 3, line_dim=2, tiling=2,
                                    fill_missing_edges=False, fill_fn=eye,
                                    device=CPU)
    assert _z(t) == pytest.approx(2.0**4, rel=1e-12)


def test_plaquette_generators_match():
    for tiling in (1, 2):
        assert list(tb.gen_2d_plaquettes(3, 4, tiling)) == list(
            jb.gen_2d_plaquettes(3, 4, tiling))
        assert list(tb.gen_3d_plaquettes(2, 3, 2, tiling)) == list(
            jb.gen_3d_plaquettes(2, 3, 2, tiling))
    with pytest.raises(ValueError, match="tiling"):
        list(tb.gen_2d_plaquettes(2, 2, 3))


def test_convert_to_2d_and_3d_match():
    edges = ttn.edges_2d_square(2, 3)
    j = jtn.TN_from_edges_and_fill_fn(_fill(7), edges, 2)
    from quimb_torch import convert

    t = convert.from_tpu_tngen(j, device=CPU)
    a, b = tb.convert_to_2d(t), jb.convert_to_2d(j)
    assert (a.Lx, a.Ly) == (b.Lx, b.Ly) == (2, 3)
    assert _sizes(a) == _sizes(b)
    e3 = ttn.edges_3d_cubic(2, 2, 1)
    j3 = jtn.TN_from_edges_and_fill_fn(_fill(8), e3, 2)
    a = tb.convert_to_3d(convert.from_tpu_tngen(j3, device=CPU))
    b = jb.convert_to_3d(j3)
    assert (a.Lx, a.Ly, a.Lz) == (b.Lx, b.Ly, b.Lz)
    assert _sizes(a) == _sizes(b)
    _same_value(a, b)


# -- classical Ising partition functions ---------------------------------------


@pytest.mark.parametrize("j, asymm", [(0.7, None), (-0.4, "l"), (-0.4, "r")])
def test_ising_matrices_match(j, asymm):
    np.testing.assert_allclose(
        tb.classical_ising_sqrtS_matrix(BETA, j, asymm),
        np.asarray(jb.classical_ising_sqrtS_matrix(BETA, j, asymm)),
        atol=1e-15)
    kw = dict(beta=BETA, j=(j, 0.3, 0.5), h=0.2, directions="lru",
              asymm=(asymm, "r", None) if asymm else None)
    for output in (False, True):
        np.testing.assert_allclose(
            tb.classical_ising_T_matrix(output=output, **kw),
            np.asarray(jb.classical_ising_T_matrix(output=output, **kw)),
            atol=1e-14)
    with pytest.raises(ValueError, match="asymm"):
        tb.classical_ising_sqrtS_matrix(BETA, -1.0, "x")


def test_coupling_parsers_match():
    J = {((0, 0), (0, 1)): 0.3}
    f, g = tb.parse_j_coupling_to_function(J), \
        jb.parse_j_coupling_to_function(J)
    assert f((0, 1), (0, 0)) == g((0, 1), (0, 0)) == 0.3
    assert tb.parse_j_coupling_to_function(2.0)(1, 2) == 2.0
    rng = np.random.default_rng(1)
    M = np.triu(rng.normal(size=(4, 4)))
    for m, uplo in ((M, "auto"), (M.T, "L"), (M + M.T, "auto")):
        np.testing.assert_array_equal(
            tb.make_couplings_matrix_symmetric(m, uplo),
            jb.make_couplings_matrix_symmetric(m, uplo))
    with pytest.raises(ValueError, match="triangular nor"):
        tb.make_couplings_matrix_symmetric(rng.normal(size=(3, 3)))


ISING = {
    "htn 2d": lambda pkg, **kw: pkg.HTN2D_classical_ising_partition_function(
        3, 3, BETA, h=0.1, j=0.8, **kw),
    "htn 2d cyclic": lambda pkg, **kw:
        pkg.HTN2D_classical_ising_partition_function(
            3, 3, BETA, cyclic=True, **kw),
    "htn 3d": lambda pkg, **kw: pkg.HTN3D_classical_ising_partition_function(
        2, 2, 3, BETA, h=-0.2, **kw),
    "tn 2d": lambda pkg, **kw: pkg.TN2D_classical_ising_partition_function(
        3, 3, BETA, h=0.1, j=-0.6, **kw),
    "tn 2d cyclic": lambda pkg, **kw:
        pkg.TN2D_classical_ising_partition_function(
            3, 3, BETA, cyclic=(False, True),
            j={((0, 0), (0, 1)): 0.5, **{
                (a, b): 1.0 for a, b in itertools.product(
                    itertools.product(range(3), range(3)), repeat=2)
                if (a, b) != ((0, 0), (0, 1))}}, **kw),
    "tn 3d": lambda pkg, **kw: pkg.TN3D_classical_ising_partition_function(
        2, 2, 3, BETA, h=0.2, j=0.9, **kw),
    "tn 3d cyclic": lambda pkg, **kw:
        pkg.TN3D_classical_ising_partition_function(
            3, 2, 2, BETA, cyclic=True, j=-0.5, **kw),
}


@pytest.mark.parametrize("name", sorted(ISING))
def test_ising_partition_functions_match(name):
    t = ISING[name](ttn, device=CPU)
    j = ISING[name](jtn)
    assert type(t).__name__ == type(j).__name__
    assert [x.inds for x in t] == [x.inds for x in j] or name.startswith(
        "tn")
    _same_value(t, j)


def test_ising_marginals_match():
    outs = [(0, 0), (1, 2)]
    t = ttn.TN2D_classical_ising_partition_function(2, 3, BETA, h=0.1,
                                                    outputs=outs,
                                                    device=CPU)
    j = jtn.TN2D_classical_ising_partition_function(2, 3, BETA, h=0.1,
                                                    outputs=outs)
    oix = ("s0,0", "s1,2")
    ref = np.asarray(j.contract(..., output_inds=oix).data)
    np.testing.assert_allclose(
        t.contract(..., output_inds=oix).data.numpy(), ref, rtol=1e-12,
        atol=1e-12 * np.abs(ref).max())
    t = ttn.TN3D_classical_ising_partition_function(
        2, 2, 2, BETA, outputs=(1, 1, 0), device=CPU)
    j = jtn.TN3D_classical_ising_partition_function(
        2, 2, 2, BETA, outputs=(1, 1, 0))
    ref = np.asarray(j.contract(..., output_inds=("s1,1,0",)).data)
    np.testing.assert_allclose(
        t.contract(..., output_inds=("s1,1,0",)).data.numpy(), ref,
        rtol=1e-12, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("kw", [
    {},
    dict(outputs=(1, 3)),
    dict(outputs=(2,), sites_location="diag"),
    dict(ordering=[3, 1, 0, 2], contract_sites=False),
])
def test_embedded_ising_matches(kw):
    rng = np.random.default_rng(5)
    J = np.tril(rng.normal(size=(4, 4)), -1)
    t = ttn.TN2D_embedded_classical_ising_partition_function(
        J, BETA, device=CPU, **kw)
    j = jtn.TN2D_embedded_classical_ising_partition_function(J, BETA, **kw)
    out = tuple(f"s{s}" for s in sorted(kw.get("outputs", ())))
    a = t.contract(..., output_inds=out)
    b = j.contract(..., output_inds=out)
    ref = np.asarray(getattr(b, "data", b))
    np.testing.assert_allclose(np.asarray(getattr(a, "data", a)), ref,
                               rtol=1e-12, atol=1e-12 * np.abs(ref).max())
    Jd = {(0, 1): 0.4, (1, 2): -0.3}
    _same_value(
        ttn.TN2D_embedded_classical_ising_partition_function(
            Jd, BETA, device=CPU),
        jtn.TN2D_embedded_classical_ising_partition_function(Jd, BETA))


# -- SAT / model counting ---------------------------------------------------------


CNF = """c a small instance
p cnf 4 3
1 -2 3 0
-1 2 0
2 3 -4 0
"""


@pytest.mark.parametrize("mode", ["parafac", "dense"])
def test_cnf_and_ksat_match(mode, tmp_path):
    f = tmp_path / "small.cnf"
    f.write_text(CNF)
    _same_value(ttn.HTN_from_cnf(str(f), mode=mode, device=CPU),
                jtn.HTN_from_cnf(str(f), mode=mode))
    kw = dict(alpha=2.0, seed=7)
    assert ttn.random_ksat_instance(3, 8, **kw) == \
        jtn.random_ksat_instance(3, 8, **kw)
    t = ttn.HTN_random_ksat(3, 8, mode=mode, device=CPU, **kw)
    j = jtn.HTN_random_ksat(3, 8, mode=mode, **kw)
    assert [x.shape for x in t] == [x.shape for x in j]
    _same_value(t, j)
    with pytest.raises(ValueError, match="both"):
        ttn.random_ksat_instance(3, 8, num_clauses=3, alpha=1.0)
    with pytest.raises(ValueError, match="either"):
        ttn.random_ksat_instance(3, 8)
