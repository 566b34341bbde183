"""quimb_torch's ``tensor/tn1d/mera.py`` against quimb_tpu's, on the CPU in
float64. Both draw their tensors from numpy (``MERA.rand`` replaces the
module's generator), so one seed gives equal arrays (compared exactly);
the isometrized MERA's norm and energy agree to 1e-12 relative (one
exact contraction of a few hundred numbers each; the energy from
the dense state and the Heisenberg MPO's dense matrix)."""

import numpy as np
import pytest
import torch

import quimb_torch.tensor as ttn
import quimb_tpu.tensor as jtn
from quimb_torch import convert


def _arrays(tn):
    return [np.asarray(t.data.numpy() if isinstance(t.data, torch.Tensor)
                       else t.data) for t in tn]


@pytest.mark.parametrize("L", [4, 8])
def test_rand_tensors_equal(L):
    j = jtn.MERA.rand(L, seed=5)
    t = ttn.MERA.rand(L, seed=5, device="cpu")
    assert t.num_tensors == j.num_tensors and t.num_layers == j.num_layers
    for a, b, ta, tb in zip(_arrays(j), _arrays(t), j, t):
        np.testing.assert_array_equal(a, b)
        assert ta.tags == tb.tags
    # the draws continue from the replaced module generator in both
    j2, t2 = jtn.MERA(L), ttn.MERA(L, device="cpu")
    for a, b in zip(_arrays(j2), _arrays(t2)):
        np.testing.assert_array_equal(a, b)


def test_rand_invar_and_from_fill_fn():
    j = jtn.MERA.rand_invar(8, seed=3)
    t = ttn.MERA.rand_invar(8, seed=3, device="cpu")
    for a, b in zip(_arrays(j), _arrays(t)):
        np.testing.assert_array_equal(a, b)
    uni = [tt for tt in t if "UNI" in tt.tags]
    assert all(torch.equal(uni[0].data, u.data) for u in uni)
    rj, rt = np.random.default_rng(1), np.random.default_rng(1)
    fj = jtn.MERA.from_fill_fn(lambda s: rj.standard_normal(s), 8)
    ft = ttn.MERA.from_fill_fn(lambda s: rt.standard_normal(s), 8,
                               device="cpu")
    for a, b in zip(_arrays(fj)[:-1], _arrays(ft)[:-1]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="power of 2"):
        ttn.MERA(6, device="cpu")


def test_isometrize_norm_and_energy_match():
    L = 8
    j = jtn.MERA.rand(L, seed=11).isometrize()
    t = ttn.MERA.rand(L, seed=11, device="cpu").isometrize()
    for tt in t:
        if "ISO" in tt.tags or "UNI" in tt.tags:
            left = tt.inds[:2]
            m = tt.transpose(*left, *tt.inds[2:]).data.reshape(4, -1)
            assert torch.allclose(m.T @ m, torch.eye(m.shape[1],
                                                     dtype=m.dtype),
                                  atol=1e-12)
    nj, nt = float(j.H @ j), float(t.H @ t)
    assert abs(nt - nj) <= 1e-12 and abs(nt - 1) <= 1e-12
    jH = jtn.MPO_ham_heis(L)
    tH = convert.from_tpu_mpo(jH, device="cpu")
    kix = [f"k{i}" for i in range(L)]
    vj = np.asarray(j.contract(..., output_inds=kix).data).reshape(-1)
    vt = t.contract(..., output_inds=kix).data.numpy().reshape(-1)
    ej = vj @ np.asarray(jH.to_dense()) @ vj
    et = vt @ tH.to_dense().numpy() @ vt
    assert abs(et - ej) <= 1e-12 * abs(ej)


def test_from_tpu_mera():
    j = jtn.MERA.rand(4, seed=2)
    t = convert.from_tpu_mera(j, device="cpu")
    assert type(t) is ttn.MERA and t.L == 4 and t.num_layers == 2
    for a, b, ta, tb in zip(_arrays(j), _arrays(t), j, t):
        np.testing.assert_array_equal(a, b)
        assert ta.left_inds == tb.left_inds
