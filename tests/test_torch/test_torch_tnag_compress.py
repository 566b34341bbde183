"""quimb_torch's arbitrary-geometry compressions (``tensor/tnag/compress.py``),
the 2D dispatcher (``tensor/tn2d/compress.py``) and the direct sums
``PEPS.add_PEPS`` / ``PEPO.add_PEPO`` against quimb_tpu's, in float64 on
the CPU.

Networks cross from quimb_tpu by ``convert.from_tpu_tngen`` /
``from_tpu_peps`` / ``from_tpu_pepo`` (the same arrays, index names and
bond order, so both packages visit the bonds in one order). The compressed
states are compared as dense vectors: a few dozen QR / SVD splits of O(1)
numbers with non-degenerate spectra, 1e-10.
"""

import numpy as np
import pytest
import torch

import quimb_tpu.tensor as jtn
import quimb_torch.tensor as ttn
from quimb_torch import convert
from quimb_tpu.ops.contraction import contract_backend as jbackend

CPU = "cpu"
METHODS = ["superorthogonal", "local-early", "local-late", "projector"]


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


def _n(x):
    x = getattr(x, "data", x)
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().numpy()
    return np.asarray(x)


def _vec(tn):
    return _n(tn.to_dense()).reshape(-1)


def _fid(a, b):
    return abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))


def _padded():
    """quimb_tpu's test case (tests/test_tensor/test_tnag_bp.py,
    ``TestAGCompress.test_pad_and_recompress``): a random D=2 network on a
    2 x 3 ladder and a copy with every bond zero-padded to D=4, its
    arrays from ``default_rng`` (quimb_tpu's test draws from JAX)."""
    edges = [((i, j), (i, j + 1)) for i in range(2) for j in range(2)]
    edges += [((0, j), (1, j)) for j in range(3)]
    rng = np.random.default_rng(0)
    psi2 = jtn.TN_from_edges_and_fill_fn(lambda s: rng.normal(size=s),
                                         edges, 2, phys_dim=2)
    psi4 = psi2.copy()
    for ix in tuple(psi4.inner_inds()):
        for tid in tuple(psi4.ind_map[ix]):
            t = psi4.tensor_map[tid]
            pads = [(0, 0)] * t.ndim
            pads[t.inds.index(ix)] = (0, 2)
            t.modify(data=np.pad(np.asarray(t.data), pads))
    return psi2, psi4


@pytest.mark.parametrize("method", METHODS)
def test_pad_and_recompress_matches(method):
    psi2, psi4 = _padded()
    want = jtn.tensor_network_ag_compress(psi4, max_bond=2, method=method)
    t4 = convert.from_tpu_tngen(psi4, device=CPU)
    got = ttn.tensor_network_ag_compress(t4, max_bond=2, method=method)
    assert got.max_bond() == want.max_bond() == 2
    assert type(got).__name__ == "TensorNetworkGenVector"
    np.testing.assert_allclose(_vec(got), _vec(want), rtol=0, atol=1e-10)
    assert _fid(_vec(got), _vec(psi2)) > 1 - 1e-8
    # in place, and through the named function of the method
    fn = getattr(ttn, "tensor_network_ag_compress_" + method.replace(
        "-", "_"))
    inp = t4.copy()
    assert fn(inp, max_bond=2, inplace=True) is inp
    np.testing.assert_allclose(_vec(inp), _vec(got), rtol=0, atol=1e-12)


@pytest.mark.parametrize("method", METHODS)
def test_truncating_compress_matches(method):
    """A random D=3 network on a 2 x 3 ladder compressed to D=2: a real
    truncation, the same result in both packages."""
    edges = ttn.edges_2d_square(2, 3)
    rng = np.random.default_rng(1)
    j = jtn.TN_from_edges_and_fill_fn(lambda s: rng.normal(size=s), edges, 3,
                                      phys_dim=2)
    t = convert.from_tpu_tngen(j, device=CPU)
    want = jtn.tensor_network_ag_compress(j, max_bond=2, method=method)
    got = ttn.tensor_network_ag_compress(t, max_bond=2, method=method)
    assert got.max_bond() == 2
    np.testing.assert_allclose(_vec(got), _vec(want), rtol=0, atol=1e-10)
    assert 0.5 < _fid(_vec(got), _vec(t)) < 1 - 1e-6


def _peps_pair(seed, D=2, L=(2, 3)):
    rng = np.random.default_rng(seed)
    Lx, Ly = L
    arrays = [[rng.standard_normal(
        [D] * sum((i < Lx - 1, j < Ly - 1, i > 0, j > 0)) + [2])
        for j in range(Ly)] for i in range(Lx)]
    j = jtn.PEPS(arrays, shape="urdlp")
    return j, convert.from_tpu_peps(j, device=CPU)


@pytest.mark.parametrize("method", METHODS)
def test_2d_compress_matches(method):
    """``tensor_network_2d_compress`` falls through to the arbitrary-geometry
    methods and keeps the PEPS class."""
    j, t = _peps_pair(2, D=3)
    want = jtn.tensor_network_2d_compress(j, max_bond=2, method=method)
    got = ttn.tensor_network_2d_compress(t, max_bond=2, method=method)
    assert isinstance(got, ttn.PEPS) and got.max_bond() == 2
    np.testing.assert_allclose(_vec(got), _vec(want), rtol=0, atol=1e-10)
    with pytest.raises(KeyError):
        ttn.tensor_network_2d_compress(t, max_bond=2, method="l2bp")


def test_add_peps_matches():
    ja, ta = _peps_pair(3)
    jb, tb = _peps_pair(4)
    got = ta.add_PEPS(tb)
    want = ja.add_PEPS(jb)
    assert isinstance(got, ttn.PEPS) and got.max_bond() == 4
    np.testing.assert_allclose(_vec(got), _vec(want), rtol=0, atol=1e-10)
    np.testing.assert_allclose(_vec(got), _vec(ta) + _vec(tb), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(_vec(ta + tb), _vec(got), rtol=0, atol=1e-12)
    inp = ta.copy()
    inp.add_PEPS_(tb)
    np.testing.assert_allclose(_vec(inp), _vec(got), rtol=0, atol=1e-12)


def test_sum_of_a_state_with_itself_compresses_by_half():
    """``psi.add_PEPS(psi)`` is ``2 psi`` at twice the bond; each bond's
    spectrum in the simple-gauge metric is then doubly degenerate, and a
    local compression back to D keeps half of each degenerate pair: both
    packages lose about half the state (normalised overlap near 0.5 here),
    and compressing to 2D keeps it whole."""
    j, t = _peps_pair(5)
    phi = t.add_PEPS(t)
    np.testing.assert_allclose(_vec(phi), 2 * _vec(t), rtol=0, atol=1e-10)
    for method in ("local-early", "superorthogonal"):
        half = ttn.tensor_network_2d_compress(phi, max_bond=2, method=method)
        jhalf = jtn.tensor_network_2d_compress(j.add_PEPS(j), max_bond=2,
                                               method=method)
        f = _fid(_vec(half), _vec(t))
        assert f == pytest.approx(_fid(_vec(jhalf), _vec(t)), abs=1e-10)
        assert f < 0.9
        whole = ttn.tensor_network_2d_compress(phi, max_bond=4,
                                               method=method)
        assert _fid(_vec(whole), _vec(t)) > 1 - 1e-10


def test_add_pepo_matches():
    ja = jtn.PEPO_rand(2, 2, 2, seed=3)
    jb = jtn.PEPO_rand(2, 2, 2, seed=4)
    ta = convert.from_tpu_pepo(ja, device=CPU)
    tb = convert.from_tpu_pepo(jb, device=CPU)
    got = ta.add_PEPO(tb)
    assert isinstance(got, ttn.PEPO) and got.max_bond() == 4
    np.testing.assert_allclose(_n(got.to_dense()), _n(ja.add_PEPO(jb)
                                                       .to_dense()),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(_n(got.to_dense()),
                               _n(ta.to_dense()) + _n(tb.to_dense()),
                               rtol=0, atol=1e-10)
