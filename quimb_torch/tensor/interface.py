"""Pack and unpack tensor networks to parameter dicts, and register
``Tensor``, ``TensorNetwork`` and their subclasses with torch's pytree.

Port of quimb_tpu's ``tensor/interface.py`` (reference
``quimb/tensor/interface.py``: ``pack`` / ``unpack`` :34-88, pytree
registration :93-123). The skeleton carries the host-side bookkeeping;
only the arrays are leaves, so ``torch.utils._pytree.tree_map`` and
friends walk a network's tensors. quimb_tpu's ``jax_register_pytree``
(a JAX alias that re-registers nothing) is left out.
"""

from torch.utils import _pytree as pytree

from .core import Tensor, TensorNetwork


def pack(obj):
    """Split ``obj`` (a Tensor or TensorNetwork) into ``(params,
    skeleton)``: ``params`` a dict of arrays, ``skeleton`` the object
    without them."""
    if isinstance(obj, Tensor):
        return {0: obj.data}, _TensorSkeleton(obj)
    params = {i: t.data for i, t in enumerate(obj.tensor_map.values())}
    return params, _TNSkeleton(obj)


class _TensorSkeleton:
    def __init__(self, t):
        self.cls = t.__class__
        self.inds = t.inds
        self.tags = tuple(t.tags)
        self.left_inds = t.left_inds

    def unpack(self, params):
        t = Tensor(params[0], inds=self.inds, tags=self.tags,
                   left_inds=self.left_inds)
        if self.cls is not Tensor:
            t.__class__ = self.cls
        return t

    def __eq__(self, other):
        return (isinstance(other, _TensorSkeleton)
                and self.inds == other.inds and self.tags == other.tags)

    def __hash__(self):
        return hash((self.inds, self.tags))


class _TNSkeleton:
    def __init__(self, tn):
        self.cls = tn.__class__
        self.tids = tuple(tn.tensor_map)
        self.tensor_meta = tuple((t.inds, tuple(t.tags), t.left_inds)
                                 for t in tn.tensor_map.values())
        self.extra = tuple((ep, _freeze(getattr(tn, ep, None)))
                           for ep in tn._EXTRA_PROPS)
        self.exponent = tn.exponent

    def unpack(self, params):
        tn = TensorNetwork(())
        for i, (tid, (inds, tags, left_inds)) in enumerate(
                zip(self.tids, self.tensor_meta)):
            tn.add_tensor(Tensor(params[i], inds=inds, tags=tags,
                                 left_inds=left_inds), tid=tid, virtual=True)
        tn.exponent = self.exponent
        if self.cls is not TensorNetwork:
            tn.__class__ = self.cls
            for ep, v in self.extra:
                setattr(tn, ep, v)
        return tn

    def __eq__(self, other):
        return (isinstance(other, _TNSkeleton) and self.cls is other.cls
                and self.tensor_meta == other.tensor_meta
                and self.extra == other.extra)

    def __hash__(self):
        return hash((self.cls, self.tensor_meta, self.extra))


def _freeze(v):
    if isinstance(v, list):
        return tuple(map(_freeze, v))
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    return v


def unpack(params, skeleton):
    """Rebuild the object from ``(params, skeleton)``."""
    return skeleton.unpack(params)


# -- pytree registration ------------------------------------------------------


def _tn_flatten(tn):
    params, skeleton = pack(tn)
    return [params[i] for i in range(len(params))], skeleton


def _tn_unflatten(leaves, skeleton):
    return skeleton.unpack(dict(enumerate(leaves)))


def _tensor_flatten(t):
    return [t.data], _TensorSkeleton(t)


def _tensor_unflatten(leaves, skeleton):
    return skeleton.unpack({0: list(leaves)[0]})


_REGISTERED = set()


def register_pytree_class(cls):
    """Register a Tensor or TensorNetwork class with torch's pytree; a
    second call for one class does nothing (torch raises on a second
    registration)."""
    if cls in _REGISTERED or cls in pytree.SUPPORTED_NODES:
        _REGISTERED.add(cls)
        return
    _REGISTERED.add(cls)
    name = f"{cls.__module__}.{cls.__qualname__}"
    if issubclass(cls, Tensor):
        pytree.register_pytree_node(cls, _tensor_flatten, _tensor_unflatten,
                                    serialized_type_name=name)
    else:
        pytree.register_pytree_node(cls, _tn_flatten, _tn_unflatten,
                                    serialized_type_name=name)


def register_all():
    """Register the standard classes (reference interface.py:93-123)."""
    from .tn1d.core import Dense1D, MatrixProductOperator, MatrixProductState
    from .tn2d.core import PEPO, PEPS, TensorNetwork2D
    from .tnag.core import (
        TensorNetworkGen,
        TensorNetworkGenOperator,
        TensorNetworkGenVector,
    )

    for cls in (Tensor, TensorNetwork, MatrixProductState,
                MatrixProductOperator, Dense1D, PEPS, PEPO, TensorNetwork2D,
                TensorNetworkGen, TensorNetworkGenVector,
                TensorNetworkGenOperator):
        register_pytree_class(cls)


register_all()
