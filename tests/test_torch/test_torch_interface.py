"""quimb_torch's ``tensor/interface.py``: ``pack`` / ``unpack`` and the
registration of the network classes with torch's pytree, against
quimb_tpu's ``pack`` / ``unpack`` and JAX's pytree of the same networks,
on the CPU. Arrays are compared exactly (nothing is computed)."""

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import quimb_torch.tensor as ttn
import quimb_tpu.tensor as jtn
from quimb_torch import convert
from quimb_torch.tensor import interface


def _mps(seed=0):
    j = jtn.MPS_rand_state(5, 3, seed=seed)
    return j, convert.from_tpu_mps(j, device="cpu")


def test_pack_unpack_matches():
    j, t = _mps()
    jp, jskel = jtn.pack(j)
    tp, tskel = ttn.pack(t)
    assert list(jp) == list(tp)
    for k in jp:
        np.testing.assert_array_equal(np.asarray(jp[k]), tp[k].numpy())
    back = ttn.unpack(tp, tskel)
    assert type(back) is ttn.MatrixProductState
    assert back.L == t.L and back.site_tag_id == t.site_tag_id
    assert tuple(back.tensor_map) == tuple(t.tensor_map)
    for a, b in zip(back, t):
        assert a.inds == b.inds and a.tags == b.tags
        assert torch.equal(a.data, b.data)
    assert tskel == interface._TNSkeleton(t)
    assert hash(tskel) == hash(interface._TNSkeleton(t))


def test_tensor_pack_unpack():
    t = ttn.Tensor(torch.arange(6.0).reshape(2, 3), inds=("a", "b"),
                   tags={"X"}, left_inds=("a",))
    params, skel = interface.pack(t)
    back = interface.unpack({0: params[0] * 2}, skel)
    assert back.inds == ("a", "b") and back.tags == t.tags
    assert back.left_inds == ("a",)
    assert torch.equal(back.data, t.data * 2)


@pytest.mark.parametrize("cls", ["Tensor", "TensorNetwork",
                                 "MatrixProductState",
                                 "MatrixProductOperator", "PEPS",
                                 "TensorNetworkGenVector"])
def test_classes_are_pytree_nodes(cls):
    assert getattr(ttn, cls) in pytree.SUPPORTED_NODES


def test_tree_map_over_networks_matches_jax():
    j, t = _mps(1)
    jl = jax.tree_util.tree_leaves(j)
    tl = pytree.tree_leaves(t)
    assert len(jl) == len(tl) == 5
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    doubled = pytree.tree_map(lambda x: 2 * x, {"psi": t, "k": [t[0]]})
    assert type(doubled["psi"]) is ttn.MatrixProductState
    assert torch.equal(doubled["psi"][0].data, 2 * t[0].data)
    assert type(doubled["k"][0]) is ttn.Tensor


def test_registration_is_idempotent():
    interface.register_all()
    interface.register_pytree_class(ttn.MatrixProductState)

    class Sub(ttn.TensorNetwork):
        pass

    interface.register_pytree_class(Sub)
    interface.register_pytree_class(Sub)
    assert Sub in pytree.SUPPORTED_NODES
