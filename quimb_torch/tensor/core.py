"""Tensor and TensorNetwork — the graph-of-arrays core.

Port of quimb_tpu's ``tensor/core.py`` to torch (reference
``quimb/tensor/tensor_core.py``: ``Tensor`` :1917, ``TensorNetwork``
:4047, ``tensor_contract`` :224, ``tensor_split`` :392,
``tensor_canonize_bond`` :671, ``tensor_compress_bond`` :546, tid/tag/ind
maps :4262-4311).

TN objects are host-side bookkeeping — dicts of index names, tags and
tensor ids, cheap to mutate — while the leaves are ``torch.Tensor``s on
one device (or numpy arrays inside ``contract_backend("numpy")``). Every
numerical operation funnels into :mod:`quimb_torch.ops` (contraction
expressions cached by geometry, truncated splits). A numpy array given to
a :class:`Tensor` lands on the default device, the GPU.

Methods whose modules are not ported yet stay on the classes and raise
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports them.

Mutability semantics match the reference: tensors know their owning
networks (weakrefs) and propagate index renames; selecting with
``virtual=True`` returns views sharing the same Tensor objects, which is
what makes e.g. the DMRG energy-TN track the evolving state for free.
"""

import collections
import copy as _copy
import functools
import itertools
import math
import operator
import string
import weakref

import numpy as np
import torch

from ..ops import decomp
from ..ops.contraction import (
    array_contract,
    array_contract_expression,
    find_output_inds,
    get_contract_strategy,
    inds_to_eq,
)
from ..utils import check_opt, oset, valmap
from . import array_ops as ar


def _deferred(item, what):
    """The ``NotImplementedError`` of a method whose module is not
    ported yet, naming the ROADMAP item that ports it."""
    return NotImplementedError(
        f"{what} is not ported to quimb_torch yet: ROADMAP item {item}"
    )

# ---------------------------------------------------------------------------
# index/tag helpers
# ---------------------------------------------------------------------------

_UUID_COUNTER = itertools.count()
_RAND_PREFIX = "".join(
    np.random.default_rng().choice(list(string.ascii_lowercase), 4)
)


def rand_uuid(base=""):
    """Return a fresh unique index/tag name like ``base_a4f3k``."""
    return f"{base}_{_RAND_PREFIX}{next(_UUID_COUNTER)}"


def tags_to_oset(tags):
    """Parse a ``tags`` argument into an oset of strings."""
    if tags is None:
        return oset()
    if isinstance(tags, (str, int)):
        return oset((tags,))
    if isinstance(tags, oset):
        return tags.copy()
    return oset(tags)


def asinds(inds):
    if inds is None:
        return ()
    if isinstance(inds, str):
        return (inds,)
    return tuple(inds)


def bonds(t1, t2):
    """The indices shared between tensors (or networks) ``t1``/``t2``."""
    i1 = t1.inds if isinstance(t1, Tensor) else t1.all_inds()
    i2 = set(t2.inds if isinstance(t2, Tensor) else t2.all_inds())
    return oset(ix for ix in i1 if ix in i2)


def bonds_size(t1, t2):
    """Total size of the bond(s) between two tensors."""
    p = 1
    for ix in bonds(t1, t2):
        p *= t1.ind_size(ix)
    return p


def group_inds(t1, t2):
    """Group indices into (left-only, shared, right-only)."""
    shared = bonds(t1, t2)
    left = [ix for ix in t1.inds if ix not in shared]
    right = [ix for ix in t2.inds if ix not in shared]
    return left, list(shared), right


# ---------------------------------------------------------------------------
# module-level tensor functions
# ---------------------------------------------------------------------------


def tensor_contract(
    *tensors,
    output_inds=None,
    optimize=None,
    get=None,
    backend=None,
    preserve_tensor=False,
    drop_tags=False,
    **kwargs,
):
    """Contract a collection of tensors into one
    (reference ``tensor_contract`` tensor_core.py:224).

    Returns a scalar if no output indices remain (unless
    ``preserve_tensor``), else a new :class:`Tensor`.
    """
    inputs = [t.inds for t in tensors]
    if output_inds is None:
        output_inds = find_output_inds(inputs)
    else:
        output_inds = tuple(output_inds)

    if get == "expression":
        return array_contract_expression(
            inputs, output_inds,
            shapes=[t.shape for t in tensors], optimize=optimize,
        )

    data = array_contract(
        [t.data for t in tensors], inputs, output_inds,
        optimize=optimize, backend=backend,
        renorm=kwargs.pop("renorm", False),
    )

    if not output_inds and not preserve_tensor:
        return data

    tags = oset()
    if not drop_tags:
        for t in tensors:
            tags.update(t.tags)
    return Tensor(data=data, inds=output_inds, tags=tags)


def tensor_split(
    T,
    left_inds,
    method="svd",
    get=None,
    absorb="both",
    max_bond=None,
    cutoff=1e-10,
    cutoff_mode="rsum2",
    renorm=None,
    ltags=None,
    rtags=None,
    stags=None,
    bond_ind=None,
    right_inds=None,
    info=None,
    **split_opts,
):
    """Decompose tensor ``T`` into two (or three) tensors
    (reference ``tensor_split`` tensor_core.py:392).

    Fuses ``left_inds``/``right_inds`` into a matrix, runs the S0 split
    engine, and unfuses. ``get`` may be None (a TensorNetwork), 'tensors',
    'arrays', or 'values'.
    """
    if left_inds is None:
        left_inds = oset(T.inds) - oset(asinds(right_inds))
    left_inds = asinds(left_inds)
    if right_inds is None:
        right_inds = tuple(ix for ix in T.inds if ix not in left_inds)
    else:
        right_inds = asinds(right_inds)

    TT = T.transpose(*left_inds, *right_inds)
    left_dims = TT.shape[: len(left_inds)]
    right_dims = TT.shape[len(left_inds):]
    ml = int(np.prod(left_dims)) if left_dims else 1
    mr = int(np.prod(right_dims)) if right_dims else 1
    # host arrays stay on the host: the split drivers have LAPACK routes
    array = TT.data.reshape(ml, mr)

    if get == "values":
        # singular values must not be absorbed into the factors
        absorb = None

    left, s, right = decomp.array_split(
        array,
        method=method,
        absorb=absorb,
        max_bond=max_bond,
        cutoff=cutoff,
        cutoff_mode=cutoff_mode,
        renorm=renorm,
        info=info,
        **split_opts,
    )

    if get == "values":
        return s

    if get == "arrays":
        out = []
        if left is not None:
            out.append(left.reshape(*left_dims, -1))
        if s is not None:
            out.append(s)
        if right is not None:
            out.append(right.reshape(-1, *right_dims))
        return tuple(out)

    bond_ind = bond_ind or rand_uuid()
    ltags = T.tags | tags_to_oset(ltags)
    rtags = T.tags | tags_to_oset(rtags)

    tensors = []
    if left is not None:
        Tl = Tensor(
            data=left.reshape(*left_dims, -1),
            inds=(*left_inds, bond_ind), tags=ltags,
        )
        tensors.append(Tl)
    if s is not None and absorb is None:
        stags_ = T.tags | tags_to_oset(stags)
        Ts = Tensor(data=s, inds=(bond_ind,), tags=stags_)
        tensors.append(Ts)
    if right is not None:
        Tr = Tensor(
            data=right.reshape(-1, *right_dims),
            inds=(bond_ind, *right_inds), tags=rtags,
        )
        tensors.append(Tr)

    if get == "tensors":
        return tensors if len(tensors) > 1 else tensors[0]

    return TensorNetwork(tensors, virtual=True)


def _matmul(a, b):
    """``a @ b``, promoting torch operands to a common dtype (torch's
    matmul does not promote, numpy's and JAX's do)."""
    if isinstance(a, torch.Tensor) and a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a @ b


def tensor_canonize_bond(T1, T2, absorb="right", gauges=None, **split_opts):
    """Canonize the bond between two tensors: make ``T1`` isometric by
    QR-ing it and absorbing R into ``T2`` (reference
    ``tensor_canonize_bond`` tensor_core.py:671). In-place on both."""
    check_opt("absorb", absorb, ("left", "right", "both"))
    if absorb == "left":
        return tensor_canonize_bond(T2, T1, absorb="right", **split_opts)

    shared = list(bonds(T1, T2))
    if not shared:
        raise ValueError("tensors have no shared bond")
    left_inds = [ix for ix in T1.inds if ix not in shared]

    if absorb == "both":
        # symmetric gauge via truncation-free compression
        return tensor_compress_bond(
            T1, T2, absorb="both", cutoff=0.0, **split_opts
        )

    method = split_opts.pop("method", "qr")
    Q, _, R = decomp.array_split(
        T1.transpose(*left_inds, *shared).data.reshape(
            int(np.prod([T1.ind_size(i) for i in left_inds]) or 1), -1),
        method=method, cutoff=-1.0,
    )
    # new bond may shrink to min(dims)
    new_bond_size = Q.shape[-1]
    if len(shared) > 1:
        # fuse multiple bonds into one
        bix = rand_uuid()
    else:
        bix = shared[0]

    left_dims = [T1.ind_size(i) for i in left_inds]
    T1.modify(
        data=Q.reshape(*left_dims, new_bond_size),
        inds=(*left_inds, bix),
        left_inds=None,
    )
    t2_other = [ix for ix in T2.inds if ix not in shared]
    T2t = T2.transpose(*shared, *t2_other)
    d_other = [T2.ind_size(i) for i in t2_other]
    new_t2 = _matmul(R, T2t.data.reshape(R.shape[-1], -1))
    T2.modify(
        data=new_t2.reshape(new_bond_size, *d_other),
        inds=(bix, *t2_other),
        left_inds=None,
    )
    return T1, T2


def tensor_compress_bond(
    T1,
    T2,
    reduced=True,
    absorb="both",
    max_bond=None,
    cutoff=1e-10,
    info=None,
    **compress_opts,
):
    """Truncate the bond between two tensors using reduced-SVD
    (reference ``tensor_compress_bond`` tensor_core.py:546): QR both
    sides, SVD the small core, absorb factors back. In-place."""
    shared = list(bonds(T1, T2))
    if not shared:
        raise ValueError("tensors have no shared bond")
    l1 = [ix for ix in T1.inds if ix not in shared]
    r2 = [ix for ix in T2.inds if ix not in shared]

    if reduced:
        # QR reductions: T1 = Q1 R1, T2 = R2 Q2
        Q1, _, R1 = decomp.array_split(
            T1.transpose(*l1, *shared).data.reshape(
                int(np.prod([T1.ind_size(i) for i in l1]) or 1), -1),
            method="qr", cutoff=-1.0,
        )
        L2, _, Q2 = decomp.lq_stabilized(
            T2.transpose(*shared, *r2).data.reshape(
                -1, int(np.prod([T2.ind_size(i) for i in r2]) or 1))
        )
        U, s, VH = decomp.array_split(
            _matmul(R1, L2), method="svd", absorb=absorb,
            max_bond=max_bond, cutoff=cutoff, info=info, **compress_opts,
        )
        new_l = _matmul(Q1, U)
        new_r = _matmul(VH, Q2)
    else:
        theta = tensor_contract(
            T1, T2, output_inds=(*l1, *r2), preserve_tensor=True
        ).data.reshape(int(np.prod([T1.ind_size(i) for i in l1]) or 1), -1)
        new_l, s, new_r = decomp.array_split(
            theta, method="svd", absorb=absorb, max_bond=max_bond,
            cutoff=cutoff, info=info, **compress_opts,
        )

    bix = shared[0] if len(shared) == 1 else rand_uuid()
    chi = new_l.shape[-1]
    d1 = [T1.ind_size(i) for i in l1]
    d2 = [T2.ind_size(i) for i in r2]
    T1.modify(
        data=new_l.reshape(*d1, chi), inds=(*l1, bix), left_inds=None
    )
    T2.modify(
        data=new_r.reshape(chi, *d2), inds=(bix, *r2), left_inds=None
    )
    if absorb is None and s is not None:
        return T1, s, T2
    return T1, T2


def tensor_balance_bond(t1, t2, smudge=1e-6):
    """Scale the shared bond of two tensors so each has equal norm along
    it (reference ``tensor_balance_bond`` tensor_core.py)."""
    (ix,) = bonds(t1, t2)
    x1 = t1.transpose(ix, *[i for i in t1.inds if i != ix]).data
    x2 = t2.transpose(ix, *[i for i in t2.inds if i != ix]).data
    n1 = torch.linalg.norm(x1.reshape(x1.shape[0], -1), dim=1) + smudge
    n2 = torch.linalg.norm(x2.reshape(x2.shape[0], -1), dim=1) + smudge
    s = torch.sqrt(n2 / n1)
    t1.multiply_index_diagonal_(ix, s)
    t2.multiply_index_diagonal_(ix, 1 / s)


def new_bond(T1, T2, size=1, name=None, axis1=0, axis2=0):
    """Add a new (size-``size``, zero-padded if > 1) bond between two
    tensors (reference ``new_bond`` tensor_core.py)."""
    name = name or rand_uuid()
    T1.new_ind(name, size=size, axis=axis1)
    T2.new_ind(name, size=size, axis=axis2)


def tensor_direct_product(T1, T2, sum_inds=(), inplace=False):
    """Direct product (block-diagonal sum) of two tensors over all
    non-``sum_inds``."""
    sum_inds = asinds(sum_inds)
    if set(T1.inds) != set(T2.inds):
        raise ValueError("tensors must have the same indices")
    T2t = T2.transpose_like(T1)
    pads = [
        (0, 0) if ix in sum_inds else (0, T2t.ind_size(ix))
        for ix in T1.inds
    ]
    pads2 = [
        (0, 0) if ix in sum_inds else (T1.ind_size(ix), 0)
        for ix in T1.inds
    ]
    new_data = ar.pad(T1.data, pads) + ar.pad(T2t.data, pads2)
    if inplace:
        T1.modify(data=new_data)
        return T1
    return Tensor(new_data, inds=T1.inds, tags=T1.tags | T2.tags)


# ---------------------------------------------------------------------------
# Tensor
# ---------------------------------------------------------------------------


class Tensor:
    """A labelled, tagged multidimensional array.

    Parameters mirror the reference (tensor_core.py:1917): ``data`` any
    array-like (stored as a ``torch.Tensor``: a numpy array lands on the
    default device, the GPU), ``inds`` a sequence of index
    names matching ``data.ndim``, ``tags`` an optional set of string tags,
    ``left_inds`` an optional isometric grouping.
    """

    __slots__ = ("_data", "_inds", "_tags", "_left_inds", "_owners")

    def __init__(self, data=1.0, inds=(), tags=None, left_inds=None):
        if isinstance(data, Tensor):
            self._data = data.data
            self._inds = data.inds
            self._tags = data.tags.copy()
            self._left_inds = data.left_inds
            self._owners = {}
            return

        self._data = ar.asarray(data)
        # note: a plain string is iterated to single-char indices,
        # matching the reference constructor's ``tuple(inds)``
        self._inds = tuple(inds)
        self._tags = tags_to_oset(tags)
        self._left_inds = asinds(left_inds) if left_inds is not None else None
        self._owners = {}

        if len(self._inds) != ar.ndim(self._data):
            raise ValueError(
                f"Wrong number of inds {self._inds} supplied for array"
                f" of shape {tuple(self._data.shape)}."
            )

    # -- owner management (reference tensor_core.py:2118-2160) -----------

    def add_owner(self, tn, tid):
        self._owners[hash(tn)] = (weakref.ref(tn), tid)

    def remove_owner(self, tn):
        self._owners.pop(hash(tn), None)

    def check_owners(self):
        """Remove dead owners, return whether any remain."""
        dead = [k for k, (ref, _) in self._owners.items() if ref() is None]
        for k in dead:
            del self._owners[k]
        return len(self._owners) > 0

    @property
    def owners(self):
        return self._owners

    def modify(self, apply=None, data=None, inds=None, tags=None,
               left_inds=...):
        """Overwrite the data/inds/tags of this tensor in place, keeping
        owner networks' maps in sync."""
        if apply is not None:
            self._data = ar.asarray(apply(self._data))
        if data is not None:
            self._data = ar.asarray(data)
            if inds is None and ar.ndim(self._data) != len(self._inds):
                raise ValueError("New data shape incompatible with inds.")
        if inds is not None:
            inds = asinds(inds)
            if len(inds) != ar.ndim(self._data):
                raise ValueError("New inds incompatible with data.")
            old = self._inds
            self._inds = inds
            if old != inds and self.check_owners():
                for ref, tid in tuple(self._owners.values()):
                    tn = ref()
                    if tn is not None:
                        tn._modify_tensor_inds(old, inds, tid)
        if tags is not None:
            tags = tags_to_oset(tags)
            old_tags = self._tags
            self._tags = tags
            if old_tags != tags and self.check_owners():
                for ref, tid in tuple(self._owners.values()):
                    tn = ref()
                    if tn is not None:
                        tn._modify_tensor_tags(old_tags, tags, tid)
        if left_inds is not ...:
            self._left_inds = (
                asinds(left_inds) if left_inds is not None else None
            )

    # -- basic properties -------------------------------------------------

    @property
    def data(self):
        return self._data

    @property
    def inds(self):
        return self._inds

    @property
    def tags(self):
        return self._tags

    @property
    def left_inds(self):
        return self._left_inds

    @left_inds.setter
    def left_inds(self, left_inds):
        self._left_inds = asinds(left_inds) if left_inds is not None else None

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def ndim(self):
        return len(self._inds)

    @property
    def size(self):
        return math.prod(self.shape)

    @property
    def dtype(self):
        return self._data.dtype

    def ind_size(self, ind):
        return self.shape[self._inds.index(ind)]

    def shared_bond_size(self, other):
        return bonds_size(self, other)

    def inner_inds(self):
        freq = collections.Counter(self._inds)
        return tuple(ix for ix, c in freq.items() if c > 1)

    # -- copying -----------------------------------------------------------

    def copy(self, deep=False, virtual=False):
        if virtual:
            return self
        t = Tensor.__new__(Tensor)
        t._data = self._data
        t._inds = self._inds
        t._tags = self._tags.copy()
        t._left_inds = self._left_inds
        t._owners = {}
        return t

    __copy__ = copy

    def __getstate__(self):
        # a torch tensor pickles with its device
        return (self._data, self._inds, tuple(self._tags), self._left_inds)

    def __setstate__(self, state):
        data, inds, tags, left_inds = state
        self._data = ar.asarray(data)
        self._inds = inds
        self._tags = oset(tags)
        self._left_inds = left_inds
        self._owners = {}

    # -- tag/index manipulation --------------------------------------------

    def add_tag(self, tag):
        self.modify(tags=self._tags | tags_to_oset(tag))

    def drop_tags(self, tags=None):
        if tags is None:
            self.modify(tags=oset())
        else:
            self.modify(tags=self._tags - tags_to_oset(tags))

    def retag(self, retag_map, inplace=False):
        t = self if inplace else self.copy()
        t.modify(
            tags=oset(retag_map.get(tag, tag) for tag in t._tags)
        )
        return t

    retag_ = functools.partialmethod(retag, inplace=True)

    def reindex(self, index_map, inplace=False):
        t = self if inplace else self.copy()
        new_inds = tuple(index_map.get(ix, ix) for ix in t._inds)
        new_left = (
            tuple(index_map.get(ix, ix) for ix in t._left_inds)
            if t._left_inds is not None else None
        )
        t.modify(inds=new_inds, left_inds=new_left)
        return t

    reindex_ = functools.partialmethod(reindex, inplace=True)

    # -- data transforms ----------------------------------------------------

    def conj(self, inplace=False):
        t = self if inplace else self.copy()
        t.modify(apply=ar.do_conj)
        return t

    conj_ = functools.partialmethod(conj, inplace=True)

    @property
    def H(self):
        """Conjugated copy."""
        return self.conj()

    def transpose(self, *output_inds, inplace=False):
        t = self if inplace else self.copy()
        output_inds = asinds(output_inds if len(output_inds) != 1
                             else output_inds[0])
        if set(output_inds) != set(t._inds):
            raise ValueError(
                f"'output_inds' must be a permutation of the tensor's "
                f"inds, got {output_inds} vs {t._inds}."
            )
        if output_inds == t._inds:
            return t
        perm = tuple(t._inds.index(ix) for ix in output_inds)
        t.modify(data=ar.transpose(t._data, perm), inds=output_inds)
        return t

    transpose_ = functools.partialmethod(transpose, inplace=True)

    def transpose_like(self, other, inplace=False):
        t = self if inplace else self.copy()
        if set(t.inds) == set(other.inds):
            return t.transpose(*other.inds, inplace=True)
        # partial ordering: sort own inds by position in other
        order = {ix: i for i, ix in enumerate(other.inds)}
        new = sorted(t.inds, key=lambda ix: order.get(ix, math.inf))
        return t.transpose(*new, inplace=True)

    transpose_like_ = functools.partialmethod(transpose_like, inplace=True)

    def moveindex(self, ind, axis, inplace=False):
        t = self if inplace else self.copy()
        new = [ix for ix in t._inds if ix != ind]
        if axis < 0:
            axis += len(new) + 1
        new.insert(axis, ind)
        return t.transpose(*new, inplace=True)

    moveindex_ = functools.partialmethod(moveindex, inplace=True)

    def trace(self, left_inds, right_inds, preserve_tensor=False,
              inplace=False):
        """Trace over (sum the diagonal of) pairs of indices."""
        t = self if inplace else self.copy()
        if isinstance(left_inds, str):
            left_inds = (left_inds,)
        if isinstance(right_inds, str):
            right_inds = (right_inds,)
        remap = dict(zip(left_inds, right_inds))
        new_inds = tuple(
            remap.get(ix, ix) for ix in t._inds
        )
        out = tuple(ix for ix in dict.fromkeys(new_inds)
                    if new_inds.count(ix) == 1)
        new_data = array_contract([t._data], [new_inds], out)
        if not out and not preserve_tensor:
            return new_data
        t.modify(data=new_data, inds=out, left_inds=None)
        return t

    def sum_reduce(self, ind, inplace=False):
        t = self if inplace else self.copy()
        ax = t._inds.index(ind)
        t.modify(
            data=(np.sum(t._data, axis=ax)
                  if isinstance(t._data, np.ndarray)
                  else torch.sum(t._data, dim=ax)),
            inds=t._inds[:ax] + t._inds[ax + 1:], left_inds=None,
        )
        return t

    sum_reduce_ = functools.partialmethod(sum_reduce, inplace=True)

    def vector_reduce(self, ind, v, inplace=False):
        """Contract a vector with a single index."""
        t = self if inplace else self.copy()
        ax = t._inds.index(ind)
        t.modify(
            data=array_contract(
                [t._data, ar.like(v, t._data)], [t._inds, (ind,)],
                t._inds[:ax] + t._inds[ax + 1:]),
            inds=t._inds[:ax] + t._inds[ax + 1:], left_inds=None,
        )
        return t

    vector_reduce_ = functools.partialmethod(vector_reduce, inplace=True)

    def collapse_repeated(self, inplace=False):
        """Take the diagonal of any repeated indices."""
        t = self if inplace else self.copy()
        if len(set(t._inds)) == len(t._inds):
            return t
        out = tuple(dict.fromkeys(t._inds))
        t.modify(data=array_contract([t._data], [t._inds], out),
                 inds=out, left_inds=None)
        return t

    def multiply_index_diagonal(self, ind, x, inplace=False):
        """Multiply the axis ``ind`` by the diagonal matrix diag(x)."""
        t = self if inplace else self.copy()
        t.modify(
            data=ar.multiply_diagonal(t._data, x, t._inds.index(ind))
        )
        return t

    multiply_index_diagonal_ = functools.partialmethod(
        multiply_index_diagonal, inplace=True
    )

    def isel(self, selectors, inplace=False):
        """Select specific values of some indices (dropping them)."""
        t = self if inplace else self.copy()
        slices = tuple(
            selectors.get(ix, slice(None)) for ix in t._inds
        )
        new_inds = tuple(ix for ix in t._inds if ix not in selectors)
        t.modify(data=t._data[slices], inds=new_inds, left_inds=None)
        return t

    isel_ = functools.partialmethod(isel, inplace=True)

    def expand_ind(self, ind, size, mode="zeros", rand_strength=None):
        """Expand the size of index ``ind`` to ``size``, zero-padding
        (or noise-padding) the new entries."""
        ax = self._inds.index(ind)
        d = self.shape[ax]
        if size <= d:
            return
        pads = [(0, 0)] * self.ndim
        pads[ax] = (0, size - d)
        new = ar.pad(self._data, pads)
        if mode == "rand" or (rand_strength or 0) > 0:
            from ..gen.rand import randn

            strength = rand_strength if rand_strength else 1e-6
            noise = randn(new.shape, dtype=new.real.dtype,
                          seed=abs(hash((ind, size))) % (2**31),
                          scale=strength, device=new.device).to(new.dtype)
            new = new.clone()
            sl = tuple(slice(None) if i != ax else slice(d, None)
                       for i in range(self.ndim))
            new[sl] = noise[sl]
        self.modify(data=new)

    def new_ind(self, name, size=1, axis=0, mode="zeros"):
        """Add a new index of size 1 (then optionally expand)."""
        new_inds = list(self._inds)
        if axis < 0:
            axis += len(new_inds) + 1
        new_inds.insert(axis, name)
        self.modify(
            data=self._data.reshape(
                *self.shape[:axis], 1, *self.shape[axis:]),
            inds=tuple(new_inds)
        )
        if size > 1:
            self.expand_ind(name, size, mode=mode)

    new_ind_ = new_ind

    def fuse(self, fuse_map, inplace=False):
        """Fuse groups of indices into single indices.

        ``fuse_map`` is a dict ``{new_ind: (old_ind1, old_ind2, ...)}``
        or sequence of such pairs.
        """
        t = self if inplace else self.copy()
        items = (
            fuse_map.items() if isinstance(fuse_map, dict) else fuse_map
        )
        items = [(new, asinds(olds)) for new, olds in items]
        fused_set = {ix for _, olds in items for ix in olds}
        # new index order: each group at front, in order, then the rest
        new_inds = [new for new, _ in items] + [
            ix for ix in t._inds if ix not in fused_set
        ]
        order = []
        shape = []
        for new, olds in items:
            order.extend(t._inds.index(ix) for ix in olds)
            shape.append(
                int(np.prod([t.ind_size(ix) for ix in olds]))
            )
        for ix in t._inds:
            if ix not in fused_set:
                order.append(t._inds.index(ix))
                shape.append(t.ind_size(ix))
        t.modify(
            data=ar.transpose(t._data, order).reshape(shape),
            inds=tuple(new_inds), left_inds=None,
        )
        return t

    fuse_ = functools.partialmethod(fuse, inplace=True)

    def unfuse(self, unfuse_map, shape_map, inplace=False):
        """Reverse of fuse: ``unfuse_map = {old: (new1, new2, ...)}``,
        ``shape_map = {old: (d1, d2, ...)}``."""
        t = self if inplace else self.copy()
        new_inds = []
        new_shape = []
        for ix in t._inds:
            if ix in unfuse_map:
                new_inds.extend(unfuse_map[ix])
                new_shape.extend(shape_map[ix])
            else:
                new_inds.append(ix)
                new_shape.append(t.ind_size(ix))
        t.modify(
            data=t._data.reshape(new_shape), inds=tuple(new_inds),
            left_inds=None,
        )
        return t

    unfuse_ = functools.partialmethod(unfuse, inplace=True)

    def to_dense(self, *inds_seq, to_qarray=False):
        """Fuse index groups and return the raw (matrix) array."""
        if not inds_seq:
            return self.data
        fuse_map = [(rand_uuid(), asinds(g)) for g in inds_seq]
        t = self.fuse(fuse_map)
        return t.data

    def squeeze(self, include=None, exclude=None, inplace=False):
        """Drop all size-1 indices."""
        t = self if inplace else self.copy()
        keep_inds = []
        for ix, d in zip(t._inds, t.shape):
            removable = d == 1
            if include is not None and ix not in include:
                removable = False
            if exclude is not None and ix in exclude:
                removable = False
            if not removable:
                keep_inds.append(ix)
        if len(keep_inds) != t.ndim:
            slices = tuple(
                slice(None) if ix in keep_inds else 0 for ix in t._inds
            )
            t.modify(
                data=t._data[slices], inds=tuple(keep_inds), left_inds=None
            )
        return t

    squeeze_ = functools.partialmethod(squeeze, inplace=True)

    def norm(self):
        """Frobenius norm."""
        return ar.norm_fro(self._data)

    def normalize(self, inplace=False):
        t = self if inplace else self.copy()
        t.modify(apply=lambda d: d / ar.norm_fro(d))
        return t

    normalize_ = functools.partialmethod(normalize, inplace=True)

    def symmetrize(self, ind1, ind2, inplace=False):
        t = self if inplace else self.copy()
        perm = list(range(t.ndim))
        a1, a2 = t._inds.index(ind1), t._inds.index(ind2)
        perm[a1], perm[a2] = perm[a2], perm[a1]
        t.modify(data=(t._data + ar.transpose(t._data, perm)) / 2)
        return t

    def isometrize(self, left_inds=None, method="qr", inplace=False):
        """Project into isometric form w.r.t. ``left_inds``."""
        t = self if inplace else self.copy()
        left_inds = asinds(left_inds if left_inds is not None
                           else t.left_inds)
        right_inds = tuple(ix for ix in t._inds if ix not in left_inds)
        tt = t.transpose(*left_inds, *right_inds)
        dl = [t.ind_size(i) for i in left_inds]
        dr = [t.ind_size(i) for i in right_inds]
        mat = tt.data.reshape(int(np.prod(dl)), int(np.prod(dr)))
        Q = decomp.isometrize(mat, method=method)
        t.modify(
            data=Q.reshape(*dl, *dr),
            inds=(*left_inds, *right_inds),
            left_inds=left_inds,
        )
        return t

    isometrize_ = functools.partialmethod(isometrize, inplace=True)
    unitize = isometrize
    unitize_ = isometrize_

    def randomize(self, dtype=None, seed=None, inplace=False):
        t = self if inplace else self.copy()
        from ..gen.rand import randn

        t.modify(data=randn(t.shape, dtype=dtype or t.dtype, seed=seed,
                            device=t.data.device))
        return t

    randomize_ = functools.partialmethod(randomize, inplace=True)

    def flip(self, ind, inplace=False):
        """Reverse the order of values along index ``ind``."""
        t = self if inplace else self.copy()
        ax = t._inds.index(ind)
        t.modify(data=(np.flip(t._data, ax)
                       if isinstance(t._data, np.ndarray)
                       else torch.flip(t._data, (ax,))))
        return t

    flip_ = functools.partialmethod(flip, inplace=True)

    def largest_element(self):
        if isinstance(self._data, np.ndarray):
            return np.max(np.abs(self._data))
        return torch.max(torch.abs(self._data))

    # -- splitting / gating --------------------------------------------------

    split = tensor_split

    def distance(self, other, **contract_opts):
        from .fitting import tensor_network_distance

        return tensor_network_distance(self, other, **contract_opts)

    def gate(self, G, ind, preserve_inds=True, inplace=False):
        """Apply matrix ``G`` to index ``ind``, keeping index name."""
        t = self if inplace else self.copy()
        G = ar.like(G, t._data)
        t.modify(data=ar.tensordot_axis(t._data, G, t._inds.index(ind), 1))
        return t

    gate_ = functools.partialmethod(gate, inplace=True)

    # -- arithmetic ----------------------------------------------------------

    def _binary_op(self, other, op):
        if isinstance(other, Tensor):
            if set(self.inds) != set(other.inds):
                raise ValueError(
                    "Can only do arithmetic on tensors with matching inds."
                )
            o = other.transpose_like(self)
            return Tensor(
                op(self._data, o._data), inds=self._inds,
                tags=self._tags | other.tags,
            )
        return Tensor(op(self._data, other), inds=self._inds,
                      tags=self._tags.copy())

    def __add__(self, other):
        return self._binary_op(other, operator.add)

    def __radd__(self, other):
        return self._binary_op(other, lambda a, b: b + a)

    def __sub__(self, other):
        return self._binary_op(other, operator.sub)

    def __rsub__(self, other):
        return self._binary_op(other, lambda a, b: b - a)

    def __mul__(self, other):
        if isinstance(other, (Tensor, TensorNetwork)):
            if isinstance(other, TensorNetwork):
                return NotImplemented
            return self._binary_op(other, operator.mul)
        return self._binary_op(other, operator.mul)

    def __rmul__(self, other):
        return self._binary_op(other, lambda a, b: b * a)

    def __truediv__(self, other):
        return self._binary_op(other, operator.truediv)

    def __neg__(self):
        return Tensor(-self._data, self._inds, self._tags.copy())

    def __matmul__(self, other):
        """Contract with another tensor."""
        return tensor_contract(self, other)

    def __and__(self, other):
        """Combine into a TensorNetwork (virtual)."""
        return TensorNetwork((self, other), virtual=True)

    def __or__(self, other):
        """Combine into a TensorNetwork (copies)."""
        return TensorNetwork((self, other))

    def almost_equals(self, other, **kwargs):
        if set(self.inds) != set(other.inds):
            return False
        o = other.transpose_like(self)
        return np.allclose(
            ar.to_host(self.data), ar.to_host(o.data), **kwargs
        )

    def max_dim(self):
        return max(self.shape) if self.shape else 1

    def __repr__(self):
        return (
            f"{self.__class__.__name__}("
            f"shape={tuple(self.shape)}, inds={self._inds}, "
            f"tags={tuple(self._tags)})"
        )

    def __str__(self):
        return self.__repr__()

    def draw(self, *args, **kwargs):
        """Plot this tensor as a one-tensor network (reference
        ``Tensor.draw``; ``tensor/drawing.py:draw_tn``)."""
        from .drawing import draw_tn

        return draw_tn(TensorNetwork((self,), virtual=True), *args, **kwargs)

    graph = draw


# alias used heavily downstream
def COPY_tensor(d, inds, tags=None, dtype=None, device=None):
    """A COPY (hyper/delta) tensor: 1 where all indices equal
    (reference tensor_core.py:3853), on ``device`` (the GPU unless
    given)."""
    from ..config import get_default_dtype
    from ..ops.backend import resolve_device, to_torch_dtype

    dtype = to_torch_dtype(dtype or get_default_dtype())
    ndim = len(inds)
    data = torch.zeros((d,) * ndim, dtype=dtype,
                       device=resolve_device(device))
    idx = (torch.arange(d, device=data.device),) * ndim
    data[idx] = 1.0
    return Tensor(data, inds=inds, tags=tags)


# ---------------------------------------------------------------------------
# TensorNetwork
# ---------------------------------------------------------------------------


class TensorNetwork:
    """A collection of tensors forming a (hyper)graph, with tag and index
    maps for O(1) lookup (reference ``TensorNetwork`` tensor_core.py:4047,
    maps :4262-4311).

    ``virtual=True`` shares the given Tensor objects (views), else they
    are copied in. Combine networks/tensors with ``&`` (virtual) or ``|``
    (copy). The ``exponent`` attribute tracks a stripped scalar exponent
    (base 10) for magnitude control on huge networks
    (reference ``strip_exponent`` tensor_core.py:10501).
    """

    _EXTRA_PROPS = ()
    _CONTRACT_STRUCTURED = False

    def __init__(self, ts=(), *, virtual=False, check_collisions=True):
        self.tensor_map = {}
        self.tag_map = {}
        self.ind_map = {}
        self._inner_inds = None
        self._outer_inds = None
        self.exponent = 0.0

        if isinstance(ts, TensorNetwork):
            self.add_tensor_network(
                ts, virtual=virtual, check_collisions=check_collisions
            )
            self.exponent = ts.exponent
            for ep in ts.__class__._EXTRA_PROPS:
                setattr(self, ep, getattr(ts, ep))
            return

        for t in ts:
            self.add(t, virtual=virtual, check_collisions=check_collisions)

    # -- adding / removing ---------------------------------------------------

    def add_tensor(self, tensor, tid=None, virtual=False):
        if tid is None or tid in self.tensor_map:
            tid = rand_uuid("_T")
        t = tensor if virtual else tensor.copy()
        t.add_owner(self, tid)
        self.tensor_map[tid] = t
        for tag in t.tags:
            self.tag_map.setdefault(tag, oset()).add(tid)
        for ix in t.inds:
            self.ind_map.setdefault(ix, oset()).add(tid)
        return tid

    def add_tensor_network(self, tn, virtual=False, check_collisions=True):
        if check_collisions:
            clash = oset(tn.inner_inds()) & oset(self.ind_map)
            if clash:
                tn = tn.reindex({ix: rand_uuid() for ix in clash})
                virtual = True  # already copied by reindex
        for tid, t in tn.tensor_map.items():
            self.add_tensor(t, tid=tid, virtual=virtual)
        self.exponent = self.exponent + tn.exponent

    def add(self, t, virtual=False, check_collisions=True):
        if isinstance(t, TensorNetwork):
            self.add_tensor_network(
                t, virtual=virtual, check_collisions=check_collisions
            )
        elif isinstance(t, Tensor):
            self.add_tensor(t, virtual=virtual)
        else:
            raise TypeError(f"cannot add object of type {type(t)}")

    def _pop_tensor(self, tid):
        t = self.tensor_map.pop(tid)
        t.remove_owner(self)
        for tag in t.tags:
            tids = self.tag_map[tag]
            tids.discard(tid)
            if not tids:
                del self.tag_map[tag]
        # dedupe: a tensor may carry the same index twice (e.g. a
        # pending self-trace, or a diagonal output of simplification) —
        # the map entry must only be removed once
        for ix in dict.fromkeys(t.inds):
            tids = self.ind_map[ix]
            tids.discard(tid)
            if not tids:
                del self.ind_map[ix]
        return t

    pop_tensor = _pop_tensor

    def remove_all_tensors(self):
        for tid in tuple(self.tensor_map):
            self._pop_tensor(tid)

    def delete(self, tags, which="all"):
        """Remove all tensors matching ``tags``."""
        for tid in tuple(self._get_tids_from_tags(tags, which)):
            self._pop_tensor(tid)

    # -- owner callbacks -------------------------------------------------------

    def _modify_tensor_inds(self, old, new, tid):
        for ix in old:
            tids = self.ind_map.get(ix)
            if tids is not None:
                tids.discard(tid)
                if not tids:
                    del self.ind_map[ix]
        for ix in new:
            self.ind_map.setdefault(ix, oset()).add(tid)

    def _modify_tensor_tags(self, old, new, tid):
        for tag in old:
            tids = self.tag_map.get(tag)
            if tids is not None:
                tids.discard(tid)
                if not tids:
                    del self.tag_map[tag]
        for tag in new:
            self.tag_map.setdefault(tag, oset()).add(tid)

    def __hash__(self):
        return id(self)

    # -- copying ----------------------------------------------------------------

    def copy(self, virtual=False, deep=False):
        """Copy this network. ``virtual=True`` shares tensors."""
        if deep:
            return _copy.deepcopy(self)
        new = object.__new__(self.__class__)
        TensorNetwork.__init__(new, self, virtual=virtual,
                               check_collisions=False)
        return new

    __copy__ = copy

    def __getstate__(self):
        d = {
            "tensors": [
                (tid, t.__getstate__()) for tid, t in self.tensor_map.items()
            ],
            "exponent": self.exponent,
            "extra": {ep: getattr(self, ep) for ep in self._EXTRA_PROPS},
        }
        return d

    def __setstate__(self, d):
        self.tensor_map = {}
        self.tag_map = {}
        self.ind_map = {}
        self._inner_inds = None
        self._outer_inds = None
        self.exponent = d.get("exponent", 0.0)
        for ep, v in d.get("extra", {}).items():
            setattr(self, ep, v)
        for tid, tstate in d["tensors"]:
            t = Tensor.__new__(Tensor)
            t.__setstate__(tstate)
            self.add_tensor(t, tid=tid, virtual=True)

    # -- conversion to subclasses ---------------------------------------------

    def view_as(self, cls, inplace=False, **kwargs):
        """View this network as ``cls`` (a TensorNetwork subclass),
        setting its extra structural props from kwargs."""
        tn = self if inplace else self.copy(virtual=False)
        tn.__class__ = cls
        for ep in cls._EXTRA_PROPS:
            attr = ep.lstrip("_")
            if attr in kwargs:
                setattr(tn, ep, kwargs.pop(attr))
            elif not hasattr(tn, ep):
                raise ValueError(f"view_as missing structural prop {ep}")
        if kwargs:
            raise ValueError(f"unused kwargs {kwargs}")
        return tn

    view_as_ = functools.partialmethod(view_as, inplace=True)

    def view_like(self, like, inplace=False):
        props = {
            ep.lstrip("_"): getattr(like, ep)
            for ep in like._EXTRA_PROPS
        }
        return self.view_as(like.__class__, inplace=inplace, **props)

    view_like_ = functools.partialmethod(view_like, inplace=True)

    # -- basic queries -----------------------------------------------------------

    @property
    def tensors(self):
        return tuple(self.tensor_map.values())

    @property
    def arrays(self):
        return tuple(t.data for t in self.tensor_map.values())

    def get_params(self):
        """Pytree of all tensor data, keyed by tid (for optimization /
        autograd — reference interface.py pack/unpack)."""
        return {tid: t.data for tid, t in self.tensor_map.items()}

    def set_params(self, params):
        for tid, data in params.items():
            self.tensor_map[tid].modify(data=data)

    @property
    def num_tensors(self):
        return len(self.tensor_map)

    @property
    def num_indices(self):
        return len(self.ind_map)

    def __len__(self):
        return len(self.tensor_map)

    def __iter__(self):
        return iter(self.tensor_map.values())

    def outer_inds(self):
        """Indices appearing exactly once."""
        return tuple(
            ix for ix, tids in self.ind_map.items()
            if len(tids) == 1 and
            sum(self.tensor_map[t].inds.count(ix) for t in tids) == 1
        )

    def inner_inds(self):
        return tuple(
            ix for ix, tids in self.ind_map.items()
            if not (len(tids) == 1 and sum(
                self.tensor_map[t].inds.count(ix) for t in tids) == 1)
        )

    def all_inds(self):
        return tuple(self.ind_map)

    def ind_size(self, ind):
        tid = next(iter(self.ind_map[ind]))
        return self.tensor_map[tid].ind_size(ind)

    def ind_sizes(self):
        return {ix: self.ind_size(ix) for ix in self.ind_map}

    def inds_size(self, inds):
        p = 1
        for ix in inds:
            p *= self.ind_size(ix)
        return p

    @property
    def shape(self):
        return tuple(self.ind_size(ix) for ix in self.outer_inds())

    @property
    def dtype(self):
        return next(iter(self.tensor_map.values())).dtype

    def max_bond(self):
        bonds_ = self.inner_inds()
        return max((self.ind_size(ix) for ix in bonds_), default=None)

    def bond(self, tags1, tags2):
        """The name of the bond between tensors tagged tags1/tags2."""
        (b,) = bonds(self[tags1], self[tags2])
        return b

    def bond_size(self, tags1, tags2):
        return bonds_size(self[tags1], self[tags2])

    # -- tid lookup ---------------------------------------------------------------

    def _get_tids_from(self, xmap, xs, which):
        inverse = which[0] == "!"
        if inverse:
            which = which[1:]
        check_opt("which", which, ("all", "any"))
        sets = []
        for x in xs:
            try:
                sets.append(xmap[x])
            except KeyError:
                if which == "all" and not inverse:
                    return oset()
                sets.append(oset())
        if which == "all":
            found = oset.intersection(*sets) if sets else oset()
        else:
            found = oset.union(*sets) if sets else oset()
        if inverse:
            return oset(self.tensor_map) - found
        return found

    def _get_tids_from_tags(self, tags, which="all"):
        if tags in (None, ..., all):
            return oset(self.tensor_map)
        tags = tags_to_oset(tags)
        return self._get_tids_from(self.tag_map, tags, which)

    def _get_tids_from_inds(self, inds, which="all"):
        inds = tags_to_oset(inds)
        return self._get_tids_from(self.ind_map, inds, which)

    def select_tensors(self, tags, which="all"):
        return tuple(
            self.tensor_map[tid]
            for tid in self._get_tids_from_tags(tags, which)
        )

    def select(self, tags, which="all", virtual=True):
        """Subnetwork of tensors matching ``tags``. Virtual by default —
        the returned network *shares* tensors with this one."""
        tids = self._get_tids_from_tags(tags, which)
        ts = (self.tensor_map[tid] for tid in tids)
        tn = TensorNetwork(ts, virtual=virtual, check_collisions=False)
        return tn

    select_any = functools.partialmethod(select, which="any")
    select_all = functools.partialmethod(select, which="all")

    def select_neighbors(self, tags, which="any"):
        """Tensors sharing an index with the tagged region (but not in
        it)."""
        tids = self._get_tids_from_tags(tags, which)
        inds = oset()
        for tid in tids:
            inds.update(self.tensor_map[tid].inds)
        neighbors = self._get_tids_from_inds(inds, "any") - tids
        return tuple(self.tensor_map[tid] for tid in neighbors)

    def _ind_to_subgraph_tids(self, start_tid, exclude_inds=()):
        """Flood-fill connected component containing ``start_tid``."""
        seen = {start_tid}
        queue = [start_tid]
        while queue:
            tid = queue.pop()
            for ix in self.tensor_map[tid].inds:
                if ix in exclude_inds:
                    continue
                for otid in self.ind_map.get(ix, ()):
                    if otid not in seen:
                        seen.add(otid)
                        queue.append(otid)
        return seen

    def subgraphs(self, virtual=False):
        """Split into connected components."""
        remaining = set(self.tensor_map)
        out = []
        while remaining:
            tid = next(iter(remaining))
            comp = self._ind_to_subgraph_tids(tid)
            remaining -= comp
            out.append(TensorNetwork(
                (self.tensor_map[t] for t in comp), virtual=virtual,
                check_collisions=False,
            ))
        return out

    def __getitem__(self, tags):
        """Get the single tensor, or network of tensors, matching
        ``tags``. Structured networks (MPS/PEPS/...) also accept
        integer / coordinate site keys via ``maybe_convert_coo``."""
        if isinstance(tags, slice):
            return self.select_any(self.maybe_convert_coo(tags))
        tags = self.maybe_convert_coo(tags)
        tensors = self.select_tensors(tags, "all")
        if not tensors:
            raise KeyError(f"no tensors matching {tags!r}")
        if len(tensors) == 1:
            return tensors[0]
        return TensorNetwork(tensors, virtual=True, check_collisions=False)

    def __setitem__(self, tags, tensor):
        tids = self._get_tids_from_tags(
            self.maybe_convert_coo(tags), "all"
        )
        if len(tids) != 1:
            raise KeyError(
                f"'TensorNetwork.__setitem__' is meant for a single "
                f"existing tensor only - found {len(tids)} with tag(s) "
                f"'{tags}'."
            )
        if not isinstance(tensor, Tensor):
            raise TypeError("Can only set value with a new 'Tensor'.")
        (tid,) = tids
        self._pop_tensor(tid)
        self.add_tensor(tensor, tid=tid, virtual=True)

    def __delitem__(self, tags):
        for tid in tuple(self._get_tids_from_tags(tags, "all")):
            self._pop_tensor(tid)

    def maybe_convert_coo(self, x):
        return x

    # -- renaming -------------------------------------------------------------------

    def reindex(self, index_map, inplace=False):
        tn = self if inplace else self.copy()
        index_map = {
            k: v for k, v in index_map.items() if k in tn.ind_map
        }
        tids = oset()
        for ix in index_map:
            tids.update(tn.ind_map.get(ix, ()))
        for tid in tids:
            tn.tensor_map[tid].reindex_(index_map)
        return tn

    reindex_ = functools.partialmethod(reindex, inplace=True)

    def retag(self, tag_map, inplace=False):
        tn = self if inplace else self.copy()
        tids = oset()
        for tag in tag_map:
            tids.update(tn.tag_map.get(tag, ()))
        for tid in tids:
            tn.tensor_map[tid].retag_(tag_map)
        return tn

    retag_ = functools.partialmethod(retag, inplace=True)

    def add_tag(self, tag, where=None, which="all"):
        for tid in self._get_tids_from_tags(where, which):
            self.tensor_map[tid].add_tag(tag)

    def drop_tags(self, tags=None):
        for t in self.tensor_map.values():
            t.drop_tags(tags)
        return self

    def mangle_inner_(self, append=None, which=None):
        """Rename all inner indices to fresh unique names (optionally
        only those in ``which``)."""
        index_map = {}
        for ix in self.inner_inds():
            if which is not None and ix not in which:
                continue
            index_map[ix] = rand_uuid() if append is None else ix + append
        return self.reindex_(index_map)

    # -- data transforms ----------------------------------------------------------

    def conj(self, mangle_inner=False, inplace=False):
        tn = self if inplace else self.copy()
        for t in tn.tensor_map.values():
            t.conj_()
        if mangle_inner:
            tn.mangle_inner_(
                append=None if mangle_inner is True else mangle_inner
            )
        return tn

    conj_ = functools.partialmethod(conj, inplace=True)

    @property
    def H(self):
        return self.conj()

    def apply_to_arrays(self, fn):
        """Apply ``fn`` to every tensor's data."""
        for t in self.tensor_map.values():
            t.modify(apply=fn)
        return self

    def astype(self, dtype, inplace=False):
        tn = self if inplace else self.copy()
        return tn.apply_to_arrays(lambda x: ar.astype(x, dtype))

    astype_ = functools.partialmethod(astype, inplace=True)

    def largest_element(self):
        return max(
            (float(t.largest_element()) for t in self.tensor_map.values()),
            default=0.0,
        )

    def norm(self, **contract_opts):
        """Frobenius norm sqrt(<TN|TN>) treating outer inds as one
        vector (reference tensor_core.py:4808)."""
        norm2 = self.conj() | self
        return abs(norm2.contract(**contract_opts)) ** 0.5

    def multiply(self, x, spread_over=8, inplace=False):
        """Multiply the whole network by scalar ``x``, spread over
        several tensors to avoid under/overflow (``spread_over='all'``
        spreads across every tensor, reference tensor_core.py)."""
        tn = self if inplace else self.copy()
        if spread_over == "all":
            spread_over = tn.num_tensors
        n = min(spread_over, tn.num_tensors)
        if isinstance(x, torch.Tensor):
            x = x.item()
        xi = x ** (1 / n) if (np.isrealobj(np.asarray(x)) and x >= 0) \
            else complex(x) ** (1 / n)
        for t, _ in zip(tn.tensor_map.values(), range(n)):
            t.modify(apply=lambda d: d * xi)
        return tn

    multiply_ = functools.partialmethod(multiply, inplace=True)

    def multiply_each(self, x, inplace=False):
        tn = self if inplace else self.copy()
        return tn.apply_to_arrays(lambda d: d * x)

    multiply_each_ = functools.partialmethod(multiply_each, inplace=True)

    def negate(self, inplace=False):
        tn = self if inplace else self.copy()
        next(iter(tn.tensor_map.values())).modify(apply=lambda x: -x)
        return tn

    negate_ = functools.partialmethod(negate, inplace=True)

    def __mul__(self, other):
        return self.multiply(other)

    def __rmul__(self, other):
        return self.multiply(other)

    def __imul__(self, other):
        return self.multiply_(other)

    def __truediv__(self, other):
        return self.multiply(1 / other)

    def __itruediv__(self, other):
        return self.multiply_(1 / other)

    def __neg__(self):
        return self.negate()

    def __and__(self, other):
        return TensorNetwork((self, other), virtual=True)

    def __or__(self, other):
        return TensorNetwork((self, other))

    def __matmul__(self, other):
        """``tn1 @ tn2``: combine and fully contract — the standard
        inner-product shorthand (reference tensor_core.py
        ``TensorNetwork.__matmul__``)."""
        return TensorNetwork((self, other), virtual=True).contract(...)

    def __xor__(self, tags):
        """Contract tagged tensors: ``tn ^ tags`` or ``tn ^ ...``."""
        return self.contract(tags)

    def __ixor__(self, tags):
        return self.contract_(tags)

    def __rshift__(self, tags_seq):
        """Cumulative contract: ``tn >> [tags1, tags2, ...]``."""
        return self.contract_cumulative(tags_seq)

    # -- norm / exponent management --------------------------------------------------

    def strip_exponent(self, tid_or_tensor, value=None):
        """Scale a tensor to unit norm, accumulating log10 of the factor
        in ``self.exponent`` (reference tensor_core.py:10501)."""
        if value is None:
            if isinstance(tid_or_tensor, Tensor):
                t = tid_or_tensor
            else:
                t = self.tensor_map[tid_or_tensor]
            norm = float(t.norm())
            if norm == 0.0 or not math.isfinite(norm):
                return
            t.modify(apply=lambda d: d / norm)
            self.exponent += math.log10(norm)
        else:
            self.exponent += math.log10(float(value))

    def distribute_exponent(self):
        """Fold the accumulated exponent back into the tensors."""
        if self.exponent != 0.0:
            self.multiply_each_(10 ** (self.exponent / self.num_tensors))
            self.exponent = 0.0
        return self

    def equalize_norms(self, value=None, inplace=False):
        """Scale all tensors to equal (frobenius) norm, stripping the
        overall factor into ``exponent`` unless ``value`` given
        (reference tensor_core.py:10553)."""
        tn = self if inplace else self.copy()
        for t in tn.tensor_map.values():
            norm = float(t.norm())
            if norm == 0.0:
                continue
            t.modify(apply=lambda d, norm=norm: d / norm)
            tn.exponent += math.log10(norm)
        if value is not None:
            lv = math.log10(value)
            for t in tn.tensor_map.values():
                t.modify(apply=lambda d: d * 10 ** (lv))
                tn.exponent -= lv
        return tn

    equalize_norms_ = functools.partialmethod(equalize_norms, inplace=True)

    # -- contraction ----------------------------------------------------------------

    def contraction_info(self, output_inds=None, optimize=None):
        # mirror array_contract's single-tensor preprocessing (repeated
        # indices collapse to their diagonal before the pairwise chain)
        # so the expression here is byte-identical to — and shares the
        # cache entry of — the one the actual contraction will use
        inputs = []
        shapes = []
        for t in self.tensor_map.values():
            term = tuple(dict.fromkeys(t.inds))
            if len(term) == t.ndim:
                inputs.append(t.inds)
                shapes.append(t.shape)
            else:
                first = {}
                for ix, d in zip(t.inds, t.shape):
                    first.setdefault(ix, d)
                inputs.append(term)
                shapes.append(tuple(first[ix] for ix in term))
        if output_inds is None:
            output_inds = self.outer_inds()
        return array_contract_expression(
            inputs, output_inds, shapes=shapes, optimize=optimize,
        )

    def contraction_cost(self, optimize=None, **kwargs):
        return self.contraction_info(optimize=optimize, **kwargs).flops

    def contraction_width(self, optimize=None, **kwargs):
        return self.contraction_info(optimize=optimize, **kwargs).width

    def contraction_path(self, optimize=None, **kwargs):
        from ..ops.paths import ssa_to_linear

        info = self.contraction_info(optimize=optimize, **kwargs)
        return ssa_to_linear(info.path, len(info.inputs))

    contraction_tree = contraction_info

    def contract_tags(
        self, tags, which="any", output_inds=None, optimize=None,
        inplace=False, **contract_opts,
    ):
        """Contract just the tensors matching ``tags``, re-inserting the
        result (reference ``contract_tags`` tensor_core.py:9223)."""
        tn = self if inplace else self.copy()
        tids = tn._get_tids_from_tags(tags, which)
        if not tids:
            raise ValueError(f"No tensors matching {tags}")
        ts = [tn._pop_tensor(tid) for tid in tids]
        if output_inds is None:
            # keep indices still connected to the rest or dangling once
            all_other = oset(tn.ind_map)
            inputs = [t.inds for t in ts]
            freq = collections.Counter(itertools.chain(*inputs))
            output_inds = tuple(
                ix for ix, c in freq.items()
                if c == 1 or ix in all_other
            )
        result = tensor_contract(
            *ts, output_inds=output_inds, optimize=optimize,
            preserve_tensor=False, **contract_opts,
        )
        if isinstance(result, Tensor):
            if tn.num_tensors == 0:
                return result
            tn.add_tensor(result, virtual=True)
            return tn
        else:
            # scalar result
            if tn.num_tensors == 0:
                return result * 10 ** tn.exponent \
                    if tn.exponent else result
            tn.multiply_(result)
            return tn

    contract_tags_ = functools.partialmethod(contract_tags, inplace=True)

    def contract_cumulative(self, tags_seq, output_inds=None,
                            inplace=False, **opts):
        tn = self if inplace else self.copy()
        ctags = oset()
        for tags in tags_seq:
            ctags.update(tags_to_oset(tags))
            tn = tn.contract_tags_(ctags, which="any", **opts)
            if not isinstance(tn, TensorNetwork):
                return tn
        return tn

    def contract(
        self, tags=..., output_inds=None, optimize=None, get=None,
        backend=None, preserve_tensor=False, inplace=False, **opts,
    ):
        """Contract some or all of the network
        (reference ``TensorNetwork.contract`` tensor_core.py:9378).

        ``tags=...`` means full contraction. ``get`` may be None,
        'expression' (compiled callable), 'path-info'.
        """
        if tags is all:
            tags = ...
        if isinstance(tags, (int, slice)) or (
            tags is not ... and tags is not None and not isinstance(
                tags, (str, oset)) and not isinstance(tags, (list, tuple))
        ):
            tags = self.maybe_convert_coo(tags)

        # structured (1D) cumulative contraction hook
        if tags is not ... and self._CONTRACT_STRUCTURED:
            if isinstance(tags, slice) or tags is None:
                return self.contract_structured(
                    tags, output_inds=output_inds, inplace=inplace, **opts
                )

        if tags is not ...:
            return self.contract_tags(
                tags, output_inds=output_inds, optimize=optimize,
                inplace=inplace, **opts,
            )

        if get == "expression":
            return self.contraction_info(output_inds, optimize)
        if get == "path-info":
            return self.contraction_info(output_inds, optimize)

        result = tensor_contract(
            *self.tensor_map.values(), output_inds=output_inds,
            optimize=optimize, backend=backend,
            preserve_tensor=preserve_tensor, **opts,
        )
        if self.exponent:
            if isinstance(result, Tensor):
                result.modify(apply=lambda d: d * 10 ** self.exponent)
            else:
                result = result * 10 ** self.exponent
        return result

    contract_ = functools.partialmethod(contract, inplace=True)

    def to_dense(self, *inds_seq, optimize=None, **contract_opts):
        """Contract and fuse outer indices into a dense matrix/vector."""
        if not inds_seq:
            inds_seq = (self.outer_inds(),)
        t = self.contract(
            ..., output_inds=tuple(
                ix for g in inds_seq for ix in asinds(g)
            ),
            optimize=optimize, preserve_tensor=True, **contract_opts,
        )
        return t.to_dense(*inds_seq)

    def trace(self, left_inds, right_inds, **contract_opts):
        """Trace over matching outer index pairs."""
        tn = self.reindex(dict(zip(asinds(left_inds), asinds(right_inds))))
        return tn.contract(..., **contract_opts)

    # -- bond level ops -----------------------------------------------------------

    def _canonize_between_tids(self, tid1, tid2, **opts):
        tensor_canonize_bond(
            self.tensor_map[tid1], self.tensor_map[tid2], **opts
        )

    def canonize_between(self, tags1, tags2, **opts):
        """QR-canonize the bond between two tagged tensors
        (reference tensor_core.py:7509)."""
        (tid1,) = self._get_tids_from_tags(tags1, "all")
        (tid2,) = self._get_tids_from_tags(tags2, "all")
        self._canonize_between_tids(tid1, tid2, **opts)

    def _compress_between_tids(self, tid1, tid2, mode="basic",
                               canonize_distance=None,
                               canonize_after_distance=None,
                               callback=None, **opts):
        """Compress the bond between two tensors with an optional
        environment-aware ``mode`` (reference
        ``_compress_between_tids`` tensor_core.py:6550):

        - ``'basic'``: plain reduced-SVD of the pair.
        - ``'virtual-tree'``: tree-gauge reduced factors are gathered
          *virtually* from a radius-``r`` ball and only shape the bond
          projectors — neighboring tensors are never modified.
        - ``'full-bond'``: the dense bond environment of the rest of
          the network weights an ALS projector fit.
        - a callable ``mode(tn, tid1, tid2, **opts)``.
        """
        if canonize_distance:
            self._canonize_around_tids(
                (tid1, tid2), max_distance=canonize_distance,
            )
        if mode == "basic":
            tensor_compress_bond(
                self.tensor_map[tid1], self.tensor_map[tid2], **opts
            )
        elif mode == "virtual-tree":
            self._compress_between_virtual_tree_tids(
                tid1, tid2, **opts
            )
        elif mode == "full-bond":
            self._compress_between_full_bond_tids(tid1, tid2, **opts)
        elif mode == "local-fit":
            self._compress_between_local_fit(tid1, tid2, **opts)
        elif callable(mode):
            mode(self, tid1, tid2, **opts)
        else:
            raise ValueError(f"unknown compress mode {mode!r}")
        if canonize_after_distance:
            self._canonize_around_tids(
                (tid1, tid2), max_distance=canonize_after_distance,
            )
        if callback is not None:
            callback(self, (tid1, tid2))

    def _canonize_around_tids(self, tids, max_distance=None, **opts):
        """Tree-canonize bonds pointing toward ``tids``, optionally
        only within ``max_distance``."""
        from .networking import get_tree_span

        span = get_tree_span(self, tids=list(tids))
        if max_distance is not None:
            span = [e for e in span if e[2] <= max_distance]
        for tid_out, tid_in, _ in span:
            if tid_out in self.tensor_map and tid_in in self.tensor_map:
                t1 = self.tensor_map[tid_out]
                t2 = self.tensor_map[tid_in]
                if bonds(t1, t2):
                    tensor_canonize_bond(t1, t2, absorb="right")

    def _compress_between_virtual_tree_tids(
        self, tid1, tid2, max_bond=None, cutoff=1e-10, r=3,
        absorb="both", include=None, exclude=None, **opts,
    ):
        """Virtual tree-gauge bond compression (reference
        ``_compress_between_virtual_tree_tids`` + experimental
        ``tn_virtual_tree_gauge``): QR reduced factors flow inward
        along a radius-``r`` spanning tree into *copies* of the bond
        pair; oblique projectors computed from the gauged pair are
        inserted on the original bond — the environment informs the
        truncation without any neighbor being touched."""
        from .networking import get_tree_span

        ta = self.tensor_map[tid1]
        tb = self.tensor_map[tid2]
        created, bix, bsize = tensor_make_single_bond(ta, tb)
        if created or bsize == 1:
            return

        # spanning tree limited to the radius-r ball around the pair
        span = [
            e for e in get_tree_span(
                self, tids=[tid1, tid2], max_distance=r,
            )
            if e[2] <= r
            and (include is None or e[0] in include)
            and (exclude is None or e[0] not in exclude)
        ]
        # work on fused-multibond COPIES of just the ball (the rest of
        # the network is never touched or copied)
        ball = {tid1, tid2} | {e[0] for e in span} | {
            e[1] for e in span
        }
        tn_calc = TensorNetwork([], virtual=True)
        for tid in ball:
            tn_calc.add_tensor(
                self.tensor_map[tid].copy(), tid=tid, virtual=True,
            )
        tn_calc.fuse_multibonds_()

        def apply_r(t, ix, R):
            """Contract matrix ``R (k, b)`` into index ``ix`` of
            tensor ``t`` (index size b -> k), in place on a copy."""
            data = ar.tensordot_axis(t.data, R, t.inds.index(ix), 1)
            return Tensor(data, inds=t.inds, tags=t.tags)

        # reduced factors flowing inward, leaves first
        Rs = {}
        for (tid_out, tid_in, _) in sorted(span, key=lambda e: -e[2]):
            t = tn_calc.tensor_map[tid_out]
            for (o2, i2, _) in span:
                if i2 == tid_out and (o2, i2) in Rs:
                    gix, Rmat = Rs[o2, i2]
                    if gix in t.inds:
                        t = apply_r(t, gix, Rmat)
            tin = tn_calc.tensor_map[tid_in]
            sh = [ix for ix in t.inds if ix in tin.inds]
            if len(sh) != 1:
                continue
            (ix,) = sh
            others = [i for i in t.inds if i != ix]
            M = t.transpose(*others, ix).data.reshape(-1, t.ind_size(ix))
            _, _, R = decomp.array_split(M, method="qr", cutoff=-1.0)
            Rs[tid_out, tid_in] = (ix, R)

        # gauge copies of the pair with the inward factors
        ta_g = tn_calc.tensor_map[tid1]
        tb_g = tn_calc.tensor_map[tid2]
        for (o2, i2, _) in span:
            if (o2, i2) in Rs and i2 in (tid1, tid2):
                gix, Rmat = Rs[o2, i2]
                tgt = ta_g if i2 == tid1 else tb_g
                if gix in tgt.inds:
                    if i2 == tid1:
                        ta_g = apply_r(tgt, gix, Rmat)
                    else:
                        tb_g = apply_r(tgt, gix, Rmat)

        # reduced factors over the pair bond from the gauged copies
        b = ta_g.ind_size(bix)
        oa = [i for i in ta_g.inds if i != bix]
        arr_a = ta_g.transpose(*oa, bix).data.reshape(-1, b)
        XXa = decomp.dag(arr_a) @ arr_a
        Rl = decomp.squared_op_to_reduced_factor(XXa, right=True)
        ob = [i for i in tb_g.inds if i != bix]
        arr_b = tb_g.transpose(bix, *ob).data.reshape(b, -1)
        XXb = arr_b @ decomp.dag(arr_b)
        Rr = decomp.squared_op_to_reduced_factor(XXb, right=False)

        Pl, Pr = decomp.compute_oblique_projectors(
            Rl, Rr, max_bond=max_bond, cutoff=cutoff,
        )

        # insert on the ORIGINAL pair only
        ta.modify(data=ar.tensordot_axis(ta.data, Pl, ta.inds.index(bix), 0))
        tb.modify(data=ar.tensordot_axis(tb.data, Pr, tb.inds.index(bix), 1))

    def _compress_between_full_bond_tids(
        self, tid1, tid2, max_bond=None, cutoff=0.0, optimize="auto",
        method="eigh", renorm=False, fit=True, max_iterations=60,
        tol=1e-10, **opts,
    ):
        """Full-bond compression: the bond's projectors are computed
        from the dense environment of the *entire* rest of the network
        (reference ``_compress_between_full_bond_tids``
        tensor_core.py:6451).

        Closed networks (no outer indices) use the single-layer loop
        operator + ``similarity_compress`` exactly as the reference;
        open state networks use the two-layer norm environment's left/
        right grams with oblique projectors (optimal on trees), then
        (``fit=True``, default) an env-weighted ALS refinement — on
        loopy networks the environment can compensate most of the
        truncation, which the plain gram projectors cannot see."""
        ta = self.tensor_map[tid1]
        tb = self.tensor_map[tid2]
        created, bix, bsize = tensor_make_single_bond(ta, tb)
        if created or bsize == 1:
            return
        D = bsize
        if max_bond is None:
            max_bond = D

        outer = set(self.outer_inds())
        if not outer:
            # closed TN: loop transfer operator on the bond
            tn_env = self.copy()
            kl, kr = rand_uuid(), rand_uuid()
            tn_env.tensor_map[tid1].reindex_({bix: kl})
            tn_env.tensor_map[tid2].reindex_({bix: kr})
            E = tn_env.to_dense((kl,), (kr,), optimize=optimize)
            Cl, Cr = decomp.similarity_compress(
                E, max_bond, method=method, renorm=renorm,
            )
            # inserted operator must be (Cl @ Cr) acting on the loop
            # operator's bond orientation (reference gates Cr into ta
            # and Cl.T into tb)
            Pl, Pr = Cr.T, Cl.T
        else:
            # open TN: two-layer norm environment with the bond cut
            ket = self.copy()
            kl, kr = rand_uuid(), rand_uuid()
            ket.tensor_map[tid1].reindex_({bix: kl})
            ket.tensor_map[tid2].reindex_({bix: kr})
            bra = ket.conj()
            bmap = {
                ix: rand_uuid()
                for ix in ket.ind_map
                if ix not in (kl, kr) and len(ket.ind_map[ix]) > 1
            }
            bra.reindex_(bmap)
            bl, br = rand_uuid(), rand_uuid()
            bra.tensor_map[tid1].reindex_({kl: bl})
            bra.tensor_map[tid2].reindex_({kr: br})
            E = (ket & bra).to_dense(
                (kl,), (kr,), (bl,), (br,), optimize=optimize,
            )
            E4 = E.reshape(D, D, D, D)

            # left/right bond grams -> reduced factors -> oblique
            # projectors (the density-matrix truncation; exact when
            # the environment factorizes, i.e. tree networks)
            Gl = torch.einsum("arbr->ab", E4)
            Gr = torch.einsum("lalb->ab", E4)
            Gl = (Gl + decomp.dag(Gl)) / 2
            Gr = (Gr + decomp.dag(Gr)) / 2
            Rl = decomp.squared_op_to_reduced_factor(Gl, right=True)
            Rr = decomp.squared_op_to_reduced_factor(Gr, right=False)
            Pl, Pr = decomp.compute_oblique_projectors(
                Rl, Rr, max_bond=max_bond, cutoff=cutoff,
            )
            if fit:
                from ..experimental.cluster_update import (
                    fit_bondenv_projectors,
                )

                Pl, _, Pr = fit_bondenv_projectors(
                    E4, max_bond=max_bond, cutoff=cutoff,
                    max_iterations=max_iterations, tol=tol, Pl0=Pl, Pr0=Pr,
                )

        ta.modify(data=ar.tensordot_axis(ta.data, Pl, ta.inds.index(bix), 0))
        tb.modify(data=ar.tensordot_axis(tb.data, Pr, tb.inds.index(bix), 1))

    def _compress_between_local_fit(
        self, tid1, tid2, max_bond=None, cutoff=0.0,
        select_local_distance=1, method="als", steps=20, tol=1e-9,
        **fit_opts,
    ):
        """Compress the bond, then ALS/autodiff-fit the *local patch*
        around it back toward the uncompressed patch (reference
        ``_compress_between_local_fit`` tensor_core.py:6508)."""
        from .networking import get_local_patch

        patch = list(get_local_patch(self, [tid1, tid2],
                                     max_distance=select_local_distance))
        loc = TensorNetwork([], virtual=True)
        for t in patch:
            loc.add_tensor(self.tensor_map[t].copy(), tid=t, virtual=True)
        target = loc.copy()
        loc._compress_between_tids(tid1, tid2, max_bond=max_bond,
                                   cutoff=cutoff)
        if method == "autodiff":
            from .fitting import tensor_network_fit_autodiff

            tensor_network_fit_autodiff(loc, target, steps=steps, tol=tol,
                                        inplace=True, **fit_opts)
        else:
            loc.fit_(target, steps=steps, tol=tol, **fit_opts)
        for t in patch:
            tl = loc.tensor_map[t]
            self.tensor_map[t].modify(data=tl.data, inds=tl.inds)

    def compress_between(self, tags1, tags2, **opts):
        """Compress the bond between two tagged tensors; see
        ``_compress_between_tids`` for the env-aware ``mode``
        options."""
        (tid1,) = self._get_tids_from_tags(
            self.maybe_convert_coo(tags1), "all"
        )
        (tid2,) = self._get_tids_from_tags(
            self.maybe_convert_coo(tags2), "all"
        )
        self._compress_between_tids(tid1, tid2, **opts)

    def compress_all(self, inplace=False, **opts):
        """Compress every internal bond."""
        tn = self if inplace else self.copy()
        seen = set()
        for ix in tuple(tn.inner_inds()):
            tids = tuple(tn.ind_map.get(ix, ()))
            if len(tids) != 2:
                continue
            key = frozenset(tids)
            if key in seen:
                continue
            seen.add(key)
            tn._compress_between_tids(*tids, **opts)
        return tn

    compress_all_ = functools.partialmethod(compress_all, inplace=True)

    def split_tensor(self, tags, left_inds, **split_opts):
        """Split a single tagged tensor in place."""
        (tid,) = self._get_tids_from_tags(tags, "all")
        t = self._pop_tensor(tid)
        tl, tr = t.split(left_inds=left_inds, get="tensors", **split_opts)
        self.add_tensor(tl, virtual=True)
        self.add_tensor(tr, virtual=True)

    def replace_with_identity(self, where, which="any", inplace=False):
        """Replace tagged tensors with identity (they must form an
        identity-like region with 2 outer inds)."""
        tn = self if inplace else self.copy()
        tids = tn._get_tids_from_tags(where, which)
        ts = [tn._pop_tensor(tid) for tid in tids]
        sub = TensorNetwork(ts, virtual=True, check_collisions=False)
        outer = sub.outer_inds()
        if len(outer) != 2:
            raise ValueError("region must have exactly 2 outer inds")
        d = sub.ind_size(outer[0])
        tn.reindex_({outer[1]: outer[0]})
        return tn

    # -- selection/partition ---------------------------------------------------------

    def partition_tensors(self, tags, which="any", inplace=False):
        """Split into (rest-network, tagged-tensors)."""
        tids = self._get_tids_from_tags(tags, which)
        tn = self if inplace else self.copy()
        ts = tuple(tn._pop_tensor(tid) for tid in tids)
        return tn, ts

    def partition(self, tags, which="any", inplace=False):
        """Split into two networks: untagged and tagged."""
        tids = self._get_tids_from_tags(tags, which)
        tn = self if inplace else self.copy()
        ts = tuple(tn._pop_tensor(tid) for tid in tids)
        tagged = TensorNetwork(ts, virtual=True, check_collisions=False)
        return tn, tagged

    # -- isel / slicing ---------------------------------------------------------------

    def isel(self, selectors, inplace=False):
        """Select values of some indices across the network."""
        tn = self if inplace else self.copy()
        tids = tn._get_tids_from_inds(tuple(selectors), "any")
        for tid in tids:
            t = tn.tensor_map[tid]
            sel = {ix: v for ix, v in selectors.items() if ix in t.inds}
            if sel:
                t.isel_(sel)
        return tn

    isel_ = functools.partialmethod(isel, inplace=True)

    def cut_iter(self, *inds):
        """Iterate over all value-combinations of ``inds``, yielding the
        sliced network each time (reference ``cut_iter``
        tensor_core.py:9088) — the sliced-contraction primitive."""
        ranges = [range(self.ind_size(ix)) for ix in inds]
        for vals in itertools.product(*ranges):
            yield self.isel(dict(zip(inds, vals)))

    # -- structure hashing --------------------------------------------------------------

    def geometry_hash(self, strict_index_order=False):
        """Hash of the network geometry (inds/shapes/connectivity),
        for caching compiled expressions (reference tensor_core.py:5148)."""
        import hashlib

        parts = []
        canon = {}

        def c(ix):
            if ix not in canon:
                canon[ix] = str(len(canon))
            return canon[ix]

        for t in self.tensor_map.values():
            term = t.inds if strict_index_order else tuple(sorted(t.inds))
            parts.append(",".join(c(ix) for ix in term))
            parts.append(str(t.shape))
        return hashlib.sha1("|".join(parts).encode()).hexdigest()

    # -- misc -----------------------------------------------------------------------------

    def squeeze(self, fuse=False, include=None, exclude=None, inplace=False):
        tn = self if inplace else self.copy()
        for t in tn.tensor_map.values():
            t.squeeze_(include=include, exclude=exclude)
        return tn

    squeeze_ = functools.partialmethod(squeeze, inplace=True)

    def fuse_multibonds(self, inplace=False):
        """Fuse any multi-bonds (multiple indices shared by the same
        pair of tensors) into single indices (reference
        ``TensorNetwork.fuse_multibonds`` tensor_core.py)."""
        tn = self if inplace else self.copy()
        pair_bonds = {}
        for ix, tids in tn.ind_map.items():
            if len(tids) != 2:
                continue
            pair_bonds.setdefault(frozenset(tids), []).append(ix)
        for tids, ixs in pair_bonds.items():
            if len(ixs) > 1:
                new_ix = rand_uuid()
                for tid in tids:
                    tn.tensor_map[tid].fuse_({new_ix: ixs})
        return tn

    fuse_multibonds_ = functools.partialmethod(
        fuse_multibonds, inplace=True
    )

    def gauge_all_random(self, iterations=1, unitary=False, seed=None,
                         inplace=False):
        """Insert random invertible (or unitary) gauge pairs
        ``G @ G^-1`` on every bond — the contracted value is unchanged
        but local tensors are scrambled (reference
        ``gauge_all_random`` tensor_core.py)."""
        tn = self if inplace else self.copy()
        rng = np.random.default_rng(seed)
        for _ in range(iterations):
            for ix, tids in tuple(tn.ind_map.items()):
                if len(tids) != 2:
                    continue
                tida, tidb = tuple(tids)
                ta = tn.tensor_map[tida]
                tb = tn.tensor_map[tidb]
                d = ta.ind_size(ix)
                G = rng.normal(size=(d, d))
                if unitary:
                    G = np.linalg.qr(G)[0]
                    Ginv = G.conj().T
                else:
                    G = G + d * np.eye(d)
                    Ginv = np.linalg.inv(G)
                for t, M in ((ta, G), (tb, Ginv.T)):
                    ax = t.inds.index(ix)
                    t.modify(data=ar.tensordot_axis(
                        t.data, ar.like(M, t.data), ax, 0))
        return tn

    gauge_all_random_ = functools.partialmethod(
        gauge_all_random, inplace=True
    )

    def rank_simplify(self, inplace=False, **kwargs):
        from .simplify import rank_simplify as _rs

        return _rs(self, inplace=inplace, **kwargs)

    def full_simplify(self, seq="ADCR", inplace=False, **kwargs):
        from .simplify import full_simplify as _fs

        return _fs(self, seq=seq, inplace=inplace, **kwargs)

    full_simplify_ = functools.partialmethod(full_simplify, inplace=True)
    rank_simplify_ = functools.partialmethod(rank_simplify, inplace=True)

    def fit(self, tn_target, method="als", **kwargs):
        """Fit this network to ``tn_target`` by ``method``: 'als'
        (alternating least squares, optional solver='cg'), 'tree'
        (tree-gauge sweeps, no normal-matrix solve) or 'autodiff'
        (reference tensor_core.py:10147)."""
        from . import fitting

        fn = {
            "als": fitting.tensor_network_fit_als,
            "tree": fitting.tensor_network_fit_tree,
            "autodiff": fitting.tensor_network_fit_autodiff,
        }[method]
        return fn(self, tn_target, **kwargs)

    def distance(self, other, **kwargs):
        from .fitting import tensor_network_distance

        return tensor_network_distance(self, other, **kwargs)

    def distance_normalized(self, other, **kwargs):
        from .fitting import tensor_network_distance

        return tensor_network_distance(self, other, normalized=True,
                                       **kwargs)

    def gate_inds(self, G, inds, contract=False, **kwargs):
        from .gating import tensor_network_gate_inds

        return tensor_network_gate_inds(
            self, G, inds, contract=contract, **kwargs
        )

    gate_inds_ = functools.partialmethod(gate_inds, inplace=True)

    def draw(self, *args, **kwargs):
        """Plot this network's graph (``tensor/drawing.py:draw_tn``)."""
        from .drawing import draw_tn

        return draw_tn(self, *args, **kwargs)

    graph = draw

    def aslinearoperator(self, left_inds, right_inds, **kwargs):
        from .linop import TNLinearOperator

        return TNLinearOperator(self, left_inds, right_inds, **kwargs)

    def __repr__(self):
        return (
            f"{self.__class__.__name__}("
            f"tensors={self.num_tensors}, indices={self.num_indices})"
        )

    def __str__(self):
        return (
            f"{self.__class__.__name__}([\n" + "\n".join(
                f"    {t!r}," for t in self.tensor_map.values()
            ) + "\n])"
        )


# ---------------------------------------------------------------------------
# module-level TN combinators (reference tensor_core.py:1239-1760)
# ---------------------------------------------------------------------------

def tensor_make_single_bond(t1, t2, gauges=None, bond_ind=None):
    """Fuse any multiple bonds between ``t1`` and ``t2`` into a single
    bond, creating one of size 1 if none exists (reference
    ``tensor_make_single_bond``). Returns ``(created, bond_ind, size)``."""
    shared = list(bonds(t1, t2))
    if not shared:
        if bond_ind is None:
            bond_ind = rand_uuid()
        new_bond(t1, t2, size=1, name=bond_ind)
        return True, bond_ind, 1
    if len(shared) == 1:
        return False, shared[0], t1.ind_size(shared[0])
    if bond_ind is None:
        bond_ind = shared[0]
    if gauges is not None:
        for ix in shared:
            if ix in gauges:
                g = gauges.pop(ix)
                t1.multiply_index_diagonal_(ix, g**0.5)
                t2.multiply_index_diagonal_(ix, g**0.5)
    t1.fuse_({bond_ind: shared})
    t2.fuse_({bond_ind: shared})
    return False, bond_ind, t1.ind_size(bond_ind)


def tensor_fuse_squeeze(t1, t2, squeeze=True, gauges=None,
                        bond_ind=None):
    """Fuse any multibond between ``t1``/``t2`` into one index and
    squeeze it away if its size is 1 (reference ``tensor_fuse_squeeze``
    tensor_core.py:1239). Inplace."""
    _, bond_ind, _ = tensor_make_single_bond(
        t1, t2, gauges=gauges, bond_ind=bond_ind
    )
    if squeeze and t1.ind_size(bond_ind) == 1:
        t1.squeeze_(include=(bond_ind,))
        t2.squeeze_(include=(bond_ind,))
        if gauges is not None and bond_ind in gauges:
            s0_1_2 = float(gauges.pop(bond_ind).reshape(())) ** 0.5
            t1.modify(apply=lambda x: x * s0_1_2)
            t2.modify(apply=lambda x: x * s0_1_2)


def connect(t1, t2, ax1, ax2):
    """Connect two tensors by renaming the given axes to a shared new
    index (reference ``connect`` tensor_core.py:1760). Inplace — any
    viewing TNs see the change."""
    d1, d2 = t1.shape[ax1], t2.shape[ax2]
    if d1 != d2:
        raise ValueError(f"dimensions {d1} and {d2} do not match")
    new_ix = rand_uuid()
    inds1 = list(t1.inds)
    inds1[ax1] = new_ix
    t1.modify(inds=inds1)
    inds2 = list(t2.inds)
    inds2[ax2] = new_ix
    t2.modify(inds=inds2)


def tensor_network_sum(tnA, tnB, inplace=False):
    """Direct sum of two structurally identical TNs: indices must match
    exactly; bond dimensions add (reference ``tensor_network_sum``
    tensor_core.py:1628)."""
    tnAB = tnA if inplace else tnA.copy()
    oix = tnAB.outer_inds()
    tidsA = list(tnAB.tensor_map)
    # match tensors by identical index sets
    b_by_inds = {frozenset(t.inds): t for t in tnB.tensor_map.values()}
    for tid in tidsA:
        t = tnAB.tensor_map[tid]
        tb = b_by_inds.get(frozenset(t.inds))
        if tb is None:
            raise ValueError(
                "can only sum TNs with exactly matching indices — see "
                "tensor_network_ag_sum for matching site structure only"
            )
        sum_inds = [ix for ix in t.inds if ix in oix]
        tab = tensor_direct_product(t, tb, sum_inds)
        t.modify(data=tab.data)
    return tnAB


# ---------------------------------------------------------------------------
# parametrized / isometric tensors (reference tensor_core.py:12261,12398)
# ---------------------------------------------------------------------------

class PArray:
    """A lazy ``fn(params) -> array`` pair behaving like its resulting
    array (reference ``PArray`` tensor/array_ops.py:578), materialised
    at its first use and again after its function or parameters change."""

    __slots__ = ("_fn", "_params", "_data")

    def __init__(self, fn, params):
        self._fn = fn
        self._params = params
        self._data = None

    def copy(self):
        return PArray(self._fn, self._params)

    @property
    def fn(self):
        return self._fn

    @fn.setter
    def fn(self, fn):
        self._fn = fn
        self._data = None

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, params):
        self._params = params
        self._data = None

    @property
    def data(self):
        if self._data is None:
            self._data = ar.asarray(self._fn(self._params))
        return self._data

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def size(self):
        return int(np.prod(self.shape))

    @property
    def dtype(self):
        return self.data.dtype

    def add_function(self, g):
        """Chain a new function ``g`` on top of the current one."""
        f = self._fn
        self._fn = lambda p: g(f(p))
        self._data = None

    def __array__(self, dtype=None):
        out = ar.to_host(self.data)
        return out.astype(dtype) if dtype is not None else out


class PTensor(Tensor):
    """A tensor whose data is lazily generated from ``fn(params)``
    (reference ``PTensor`` tensor_core.py:12261). Used by TNOptimizer to
    keep e.g. unitary-constrained parametrizations."""

    def __init__(self, fn, params, inds=(), tags=None, left_inds=None):
        super().__init__(
            PArray(fn, params), inds=inds, tags=tags, left_inds=left_inds
        )

    @classmethod
    def from_parray(cls, parray, inds=(), tags=None, left_inds=None):
        obj = cls.__new__(cls)
        Tensor.__init__(obj, parray, inds=inds, tags=tags,
                        left_inds=left_inds)
        return obj

    def copy(self):
        return PTensor.from_parray(
            self._data.copy(), inds=self.inds, tags=self.tags,
            left_inds=self.left_inds,
        )

    @property
    def data(self):
        return self._data.data

    @property
    def fn(self):
        return self._data.fn

    @fn.setter
    def fn(self, x):
        self._data.fn = x

    def get_params(self):
        return self._data.params

    def set_params(self, params):
        self._data.params = params

    @property
    def params(self):
        return self.get_params()

    @params.setter
    def params(self, x):
        self.set_params(x)

    @property
    def shape(self):
        return self._data.shape

    @property
    def ndim(self):
        return self._data.ndim

    def modify(self, apply=None, data=None, inds=None, tags=None,
               left_inds=...):
        if apply is not None:
            self._data.add_function(apply)
            apply = None
        if data is not None:
            if isinstance(data, PArray):
                self._data = data
                data = None
            else:
                raise TypeError(
                    "can only set PTensor data to a PArray — use "
                    ".unparametrize() for a plain Tensor"
                )
        super().modify(apply=apply, data=data, inds=inds, tags=tags,
                       left_inds=left_inds)

    def unparametrize(self):
        """Turn into a normal (materialized) :class:`Tensor`."""
        return Tensor(self.data, inds=self.inds, tags=self.tags,
                      left_inds=self.left_inds)


class IsoTensor(Tensor):
    """A :class:`Tensor` which keeps its ``left_inds`` through
    ``modify`` (reference ``IsoTensor`` tensor_core.py:12398) — the
    marker class for isometric networks (MERA, TTN)."""

    def modify(self, **kwargs):
        kwargs.setdefault("left_inds", self.left_inds)
        super().modify(**kwargs)

    def fuse(self, *args, inplace=False, **kwargs):
        t = self if inplace else self.copy()
        t._left_inds = None
        return Tensor.fuse(t, *args, inplace=True, **kwargs)


def tensor_gauge_simple_bond(ta, tb, gauges, smudge=1e-12, power=1.0,
                             damping=0.0, max_bond=None, cutoff=0.0,
                             renorm=False, info=None):
    """One simple-update-style gauging step for two tensors sharing a
    bond (reference ``tensor_gauge_simple_bond``
    tensor_core.py:1295): absorb the surrounding gauges, split/compress
    the shared bond keeping the singular values as the new gauge,
    then unabsorb. ``gauges`` is updated in place."""
    _, bond_ix, _ = tensor_make_single_bond(ta, tb, gauges=gauges)

    absorbed = []
    for t in (ta, tb):
        for ix in t.inds:
            if ix != bond_ix and ix in gauges:
                g = (gauges[ix] + smudge) ** power
                t.multiply_index_diagonal_(ix, g)
                absorbed.append((t, ix, g))
    if bond_ix in gauges:
        s_old = gauges[bond_ix]
        sq = (s_old + smudge) ** 0.5
        ta.multiply_index_diagonal_(bond_ix, sq)
        tb.multiply_index_diagonal_(bond_ix, sq)
    else:
        s_old = None

    out = tensor_compress_bond(
        ta, tb, absorb=None, max_bond=max_bond, cutoff=cutoff,
    )
    max_sdiff = None
    if len(out) == 3:
        _, s, _ = out
        nrm = ar.norm_fro(s)
        if renorm:
            s = s / nrm
            if info is not None and "exponent" in info:
                info["exponent"] += math.log10(float(nrm))
        if damping > 0.0 and s_old is not None and \
                s_old.shape == s.shape:
            s = damping * s_old + (1 - damping) * s
        if info is not None and "max_sdiff" in info and \
                s_old is not None and s_old.shape == s.shape:
            max_sdiff = float(ar.norm_fro(s - s_old))
            info["max_sdiff"] = max(info["max_sdiff"], max_sdiff)
        gauges[bond_ix] = s

    for t, ix, g in absorbed:
        if ix in t.inds:
            t.multiply_index_diagonal_(ix, 1 / g)
    return bond_ix


# ---------------------------------------------------------------------------
# compressed contraction (reference ``contract_compressed``
# tensor_core.py:8637 / ``_contract_compressed_tid_sequence`` :8226)
# ---------------------------------------------------------------------------

def _pair_output_inds(tn, tid1, tid2):
    """Indices the contraction of ``tid1, tid2`` must keep: anything
    also held by other tensors or dangling on the full network."""
    t1 = tn.tensor_map[tid1]
    t2 = tn.tensor_map[tid2]
    keep = []
    for ix in dict.fromkeys((*t1.inds, *t2.inds)):
        holders = tn.ind_map.get(ix, ())
        n_outside = sum(1 for tid in holders if tid not in (tid1, tid2))
        n_inside = (ix in t1.inds) + (ix in t2.inds)
        total = len(holders)
        # dangling on the network, held elsewhere, or a hyper index
        # not fully consumed by this pair
        if n_outside or total < 2 or (total - n_inside) > 0:
            keep.append(ix)
        elif n_inside == 1:
            keep.append(ix)
    return keep


def tensor_network_contract_compressed(
    tn, max_bond, cutoff=1e-10, output_inds=None, canonize=True,
    compress_mode="auto", tree_gauge_distance=None,
    final_contract=True, inplace=False, progbar=False, **kwargs,
):
    """Contract a TN while keeping every intermediate bond at most
    ``max_bond`` via on-the-fly pairwise compression (reference
    ``contract_compressed`` tensor_core.py:8637). The contraction
    order is a leaves-first spanning-tree merge toward the most
    central tensor of each connected component (reference uses the
    same span machinery); after each merge the grown tensor's fat
    bonds are compressed against their neighbours.

    Returns the contracted value (scalar / tensor with
    ``output_inds``) if ``final_contract``, else the partially
    contracted network."""
    from .networking import get_tree_span, subgraphs

    tn = tn if inplace else tn.copy()
    if output_inds is None:
        output_inds = tn.outer_inds()

    # choose the bond-compression mode (reference
    # ``choose_local_compress_gauge_settings`` tensor_core.py:826):
    # with a tree-gauge radius the env-aware virtual-tree projectors
    # replace plain pair-local compression
    if tree_gauge_distance is None:
        tree_gauge_distance = 3 if canonize else 0
    if compress_mode == "auto":
        compress_mode = (
            "virtual-tree" if tree_gauge_distance > 0 else "basic"
        )
    compress_kwargs = {}
    if compress_mode == "virtual-tree":
        compress_kwargs["r"] = tree_gauge_distance

    for comp in subgraphs(tn):
        comp_tids = set(comp)
        merges = [
            (a, b) for (a, b, _) in get_tree_span(
                _component_view(tn, comp_tids)
            )
        ]
        for tid_out, tid_in in merges:
            if tid_out not in tn.tensor_map or \
                    tid_in not in tn.tensor_map:
                continue
            keep = _pair_output_inds(tn, tid_out, tid_in)
            t1 = tn._pop_tensor(tid_out)
            t2 = tn.tensor_map[tid_in]
            new = tensor_contract(
                t1, t2, output_inds=tuple(keep),
                preserve_tensor=True,
            )
            t2.modify(data=new.data, inds=new.inds,
                      tags=t2.tags | t1.tags)
            # compress any fat bonds against neighbours, with the
            # chosen (possibly env-aware) mode
            for ix in tuple(t2.inds):
                holders = tuple(tn.ind_map.get(ix, ()))
                if len(holders) == 2 and \
                        t2.ind_size(ix) > max_bond:
                    other = next(h for h in holders if h != tid_in)
                    tn._compress_between_tids(
                        other, tid_in, mode=compress_mode,
                        max_bond=max_bond, cutoff=cutoff,
                        **compress_kwargs,
                    )
    if final_contract:
        return tn.contract(
            ..., output_inds=tuple(output_inds), **kwargs
        )
    return tn


def _component_view(tn, comp_tids):
    """A lightweight object exposing tensor_map/ind_map restricted to
    one connected component (enough for the span computation)."""

    class _View:
        pass

    v = _View()
    v.tensor_map = {
        tid: t for tid, t in tn.tensor_map.items() if tid in comp_tids
    }
    v.ind_map = {
        ix: oset(t for t in tids if t in comp_tids)
        for ix, tids in tn.ind_map.items()
        if any(t in comp_tids for t in tids)
    }
    return v


TensorNetwork.contract_compressed = tensor_network_contract_compressed
TensorNetwork.contract_compressed_ = functools.partialmethod(
    tensor_network_contract_compressed, inplace=True
)


# ---------------------------------------------------------------------------
# method parity layer: reference TensorNetwork methods wired onto the
# module-level machinery (networking / simplify / gauging / drawing)
# ---------------------------------------------------------------------------

def _tn_tags(self):
    """Union of all tensor tags (reference ``TensorNetwork.tags``)."""
    out = oset()
    for t in self.tensor_map.values():
        out |= t.tags
    return out


def _tn_item(self):
    """The single scalar value of a fully-contracted network."""
    if self.num_tensors == 1:
        (t,) = self.tensor_map.values()
        if t.ndim == 0:
            return t.data.item()
    return self.contract(output_inds=()).item()


def _tn_iscomplex(self):
    return "complex" in str(self.dtype)


def _tn_dtype_name(self):
    return str(self.dtype)


def _tn_backend(self):
    return "torch"


def _tn_outer_dims_inds(self):
    """Tuple of (dim, ind) for every outer index (reference
    ``outer_dims_inds``)."""
    return tuple(
        (self.ind_size(ix), ix) for ix in self.outer_inds()
    )


def _tn_outer_size(self):
    out = 1
    for ix in self.outer_inds():
        out *= self.ind_size(ix)
    return out


def _tn_get_multibonds(self):
    """Map of ``tuple[tid] -> list[ind]`` for tensor pairs (or groups)
    sharing more than one index (reference ``get_multibonds``)."""
    groups = {}
    for ix, tids in self.ind_map.items():
        groups.setdefault(tuple(sorted(tids, key=str)), []).append(ix)
    return {
        tids: ixs for tids, ixs in groups.items()
        if len(ixs) > 1 and len(tids) > 1
    }


def _tn_get_hyperinds(self, output_inds=()):
    """Indices appearing on 3+ tensors (reference
    ``get_hyperinds``)."""
    output_inds = set(output_inds)
    return tuple(
        ix for ix, tids in self.ind_map.items()
        if (len(tids) + (ix in output_inds)) > 2
    )


def _tn_get_symbol_map(self):
    from ..ops.contraction import get_symbol

    out = {}
    for i, ix in enumerate(
        dict.fromkeys(
            ix for t in self.tensor_map.values() for ix in t.inds
        )
    ):
        out[ix] = get_symbol(i)
    return out


def _tn_get_equation(self, output_inds=None):
    """The einsum equation of the full contraction (reference
    ``get_equation``)."""
    symb = self.get_symbol_map()
    if output_inds is None:
        output_inds = self.outer_inds()
    lhs = ",".join(
        "".join(symb[ix] for ix in t.inds)
        for t in self.tensor_map.values()
    )
    rhs = "".join(symb[ix] for ix in output_inds)
    return f"{lhs}->{rhs}"


def _tn_get_inputs_output_size_dict(self, output_inds=None):
    eq = self.get_equation(output_inds=output_inds)
    lhs, rhs = eq.split("->")
    inputs = lhs.split(",")
    symb = self.get_symbol_map()
    sizes = {symb[ix]: self.ind_size(ix) for ix in symb}
    return inputs, rhs, sizes


def _tn_make_tids_consecutive(self, tid0=0):
    """Renumber tids consecutively from ``tid0`` (reference
    ``make_tids_consecutive``)."""
    ts = list(self.tensor_map.values())
    for tid in tuple(self.tensor_map):
        self._pop_tensor(tid)
    for i, t in enumerate(ts):
        self.add_tensor(t, tid=tid0 + i, virtual=True)
    return self


def _tn_tensors_sorted(self):
    """Tensors sorted by their sorted index names (canonical order,
    reference ``tensors_sorted``)."""
    return tuple(sorted(
        self.tensor_map.values(), key=lambda t: sorted(t.inds)
    ))


def _tn_randomize(self, dtype=None, seed=None, inplace=False,
                  **randn_opts):
    """Randomize every tensor's data (reference ``randomize``
    tensor_core.py:3595)."""
    from ..gen.rand import randn

    tn = self if inplace else self.copy()
    for i, t in enumerate(tn.tensor_map.values()):
        t.modify(data=randn(
            t.shape, dtype=dtype or t.dtype, device=t.data.device,
            seed=None if seed is None else seed + i, **randn_opts,
        ))
    return tn


def _tn_convert_to_zero(self):
    """Inplace: every inner dimension becomes size 1 with zero data
    (reference ``convert_to_zero`` tensor_core.py:6081)."""
    outer = set(self.outer_inds())
    for t in self.tensor_map.values():
        new_shape = tuple(
            d if ix in outer else 1
            for d, ix in zip(t.shape, t.inds)
        )
        t.modify(data=torch.zeros(new_shape, dtype=t.dtype,
                                  device=t.data.device))


def _tn_to_qarray(self, *inds_seq, **kwargs):
    """The dense network as a host numpy array (quimb_tpu wraps it in
    its ``qarray``, which the port does not have)."""
    return ar.to_host(self.to_dense(*inds_seq, **kwargs))


def _tn_sum_reduce(self, ind, inplace=False):
    """Sum over an index (contract with ones), reference
    ``TensorNetwork.sum_reduce``."""
    tn = self if inplace else self.copy()
    for tid in tuple(tn.ind_map.get(ind, ())):
        tn.tensor_map[tid].sum_reduce_(ind)
    return tn


def _tn_vector_reduce(self, ind, v, inplace=False):
    """Contract a vector into index ``ind`` (reference
    ``vector_reduce`` tensor_core.py:2896)."""
    tn = self if inplace else self.copy()
    (tid,) = tuple(tn.ind_map[ind])[:1]
    t = tn.tensor_map[tid]
    ax = t.inds.index(ind)
    data = array_contract([t.data, ar.like(v, t.data)], [t.inds, (ind,)],
                          tuple(ix for ix in t.inds if ix != ind))
    t.modify(data=data, inds=tuple(
        ix for ix in t.inds if ix != ind
    ))
    return tn


def _tn_cut_between(self, tags1, tags2, left_ind, right_ind):
    """Cut the bond between two tagged tensors into two dangling
    indices (reference ``cut_between``)."""
    (tid1,) = self._get_tids_from_tags(tags1, "all")
    (tid2,) = self._get_tids_from_tags(tags2, "all")
    t1, t2 = self.tensor_map[tid1], self.tensor_map[tid2]
    (bond,) = bonds(t1, t2)
    t1.reindex_({bond: left_ind})
    t2.reindex_({bond: right_ind})


def _tn_cut_bond(self, bond, new_left_ind=None, new_right_ind=None):
    """Cut a named bond into two dangling indices (reference
    ``cut_bond``)."""
    tid1, tid2 = tuple(self.ind_map[bond])
    if new_left_ind is None:
        new_left_ind = rand_uuid()
    if new_right_ind is None:
        new_right_ind = rand_uuid()
    self.tensor_map[tid1].reindex_({bond: new_left_ind})
    self.tensor_map[tid2].reindex_({bond: new_right_ind})
    return new_left_ind, new_right_ind


def _tn_insert_gauge(self, U, where1, where2, Uinv=None, tol=1e-10):
    """Insert ``U @ U^-1`` on the bond between two tagged tensors
    (reference ``insert_gauge``)."""
    (tid1,) = self._get_tids_from_tags(where1, "all")
    (tid2,) = self._get_tids_from_tags(where2, "all")
    t1, t2 = self.tensor_map[tid1], self.tensor_map[tid2]
    (ix,) = bonds(t1, t2)
    U = torch.as_tensor(U, device=t1.data.device)
    if Uinv is None:
        Uinv = torch.linalg.inv(U)
    t1.modify(data=ar.tensordot_axis(t1.data, U, t1.inds.index(ix), 1))
    t2.modify(data=ar.tensordot_axis(t2.data, Uinv, t2.inds.index(ix), 0))


def _tn_insert_operator(self, A, where1, where2, tags=None,
                        inplace=False):
    """Insert an operator tensor on the bond between two tagged
    tensors (reference ``insert_operator``)."""
    tn = self if inplace else self.copy()
    (tid1,) = tn._get_tids_from_tags(where1, "all")
    (tid2,) = tn._get_tids_from_tags(where2, "all")
    t1, t2 = tn.tensor_map[tid1], tn.tensor_map[tid2]
    (ix,) = bonds(t1, t2)
    db = t1.ind_size(ix)
    if A.shape[0] != db:
        raise ValueError(
            f"This operator has dimension {A.shape[0]} but needs "
            f"dimension {db}."
        )
    new_ix = rand_uuid()
    t1.reindex_({ix: new_ix})
    tn.add_tensor(
        Tensor(ar.like(A, t1.data) if not isinstance(A, torch.Tensor)
               else A, inds=(ix, new_ix),
               tags=tags_to_oset(tags)),
        virtual=True,
    )
    return tn


def _tn_new_bond(self, tags1, tags2, **opts):
    """Add a size-1 bond between two tagged tensors (reference
    ``TensorNetwork.new_bond``)."""
    (tid1,) = self._get_tids_from_tags(tags1, "all")
    (tid2,) = self._get_tids_from_tags(tags2, "all")
    new_bond(self.tensor_map[tid1], self.tensor_map[tid2], **opts)


def _tn_expand_bond_dimension(self, new_bond_dim, rand_strength=0.0,
                              inds_to_expand=None, inplace=False):
    """Zero/noise-pad all (or some) inner bonds up to
    ``new_bond_dim`` (reference ``expand_bond_dimension``
    tensor_core.py:10645)."""
    from ..gen.rand import randn

    tn = self if inplace else self.copy()
    if inds_to_expand is None:
        inds_to_expand = [
            ix for ix, tids in tn.ind_map.items() if len(tids) >= 2
        ]
    for ix in inds_to_expand:
        d = tn.ind_size(ix)
        if d >= new_bond_dim:
            continue
        for tid in tn.ind_map[ix]:
            t = tn.tensor_map[tid]
            ax = t.inds.index(ix)
            pads = [(0, 0)] * t.ndim
            pads[ax] = (0, new_bond_dim - d)
            data = ar.pad(t.data, pads)
            if rand_strength:
                noise = randn(data.shape, dtype=data.dtype,
                              scale=rand_strength, device=data.device)
                mask = ar.pad(torch.ones(t.shape, dtype=torch.bool,
                                         device=data.device), pads)
                data = torch.where(mask, data, noise)
            t.modify(data=data)
    return tn


def _tn_compute_reduced_factor(self, side, left_inds, right_inds,
                               **split_opts):
    """The left/right reduced (QR) factor of the network viewed as an
    operator from ``left_inds`` to ``right_inds`` (reference
    ``compute_reduced_factor`` tensor_core.py:2991)."""
    check_opt("side", side, ("left", "right"))
    t = self.contract(
        ..., output_inds=(*left_inds, *right_inds),
        preserve_tensor=True,
    )
    m = int(np.prod([t.ind_size(ix) for ix in left_inds]))
    mat = t.transpose(*left_inds, *right_inds).data.reshape(m, -1)
    if side == "right":
        _, _, R = decomp.qr_stabilized(mat)
        return R
    Lf, _, _ = decomp.lq_stabilized(mat)
    return Lf


def _tn_isometrize(self, method="qr", allow_no_left_inds=False,
                   inplace=False):
    """Project every tensor with ``left_inds`` onto an isometry
    (reference ``isometrize``/``unitize``)."""
    tn = self if inplace else self.copy()
    for t in tn.tensor_map.values():
        if t.left_inds is None:
            if allow_no_left_inds:
                continue
            raise ValueError(
                "tensor has no left_inds; pass "
                "allow_no_left_inds=True to skip"
            )
        t.isometrize_(left_inds=t.left_inds, method=method)
    return tn


def _tn_balance_bonds(self, inplace=False):
    """Balance the norms across every bond (reference
    ``balance_bonds``)."""
    tn = self if inplace else self.copy()
    for ix, tids in tuple(tn.ind_map.items()):
        if len(tids) != 2:
            continue
        t1, t2 = (tn.tensor_map[tid] for tid in tids)
        tensor_balance_bond(t1, t2)
    return tn


def _tn_make_norm(self, mangle_append="*", layer_tags=("KET", "BRA"),
                  return_all=False):
    """The ``<tn|tn>`` network (reference ``make_norm``)."""
    ket = self.copy()
    ket.add_tag(layer_tags[0])
    bra = ket.H
    bra.retag_({layer_tags[0]: layer_tags[1]})
    bra.mangle_inner_(mangle_append)
    norm = TensorNetwork((ket, bra), virtual=True)
    if return_all:
        return norm, ket, bra
    return norm


def _tn_make_overlap(self, other, layer_tags=("KET", "BRA")):
    """The ``<other|tn>`` overlap network (reference
    ``make_overlap``)."""
    ket = self.copy()
    ket.add_tag(layer_tags[0])
    bra = other.H
    bra.add_tag(layer_tags[1])
    bra.mangle_inner_("*")
    return TensorNetwork((ket, bra), virtual=True)


def _tn_overlap(self, other, **contract_opts):
    return self.make_overlap(other).contract(
        output_inds=(), **contract_opts
    )


def _tn_gauge_all_canonize(self, max_iterations=5, inplace=False,
                           **opts):
    """Iterative bond canonization of every bond (reference
    ``gauge_all_canonize`` tensor_core.py:7509)."""
    tn = self if inplace else self.copy()
    for _ in range(max_iterations):
        for ix, tids in tuple(tn.ind_map.items()):
            if len(tids) != 2:
                continue
            tid1, tid2 = tuple(tids)
            tensor_canonize_bond(
                tn.tensor_map[tid1], tn.tensor_map[tid2],
                absorb="right",
            )
    return tn


def _tn_gauge_all_simple(self, max_iterations=5, tol=0.0, smudge=1e-12,
                         power=1.0, damping=0.0, gauges=None,
                         inplace=False):
    """Simple (Vidal) gauging of every bond of an arbitrary TN
    (reference ``gauge_all_simple`` tensor_core.py:7555).

    If ``gauges`` is supplied (a dict, possibly empty), it is updated
    in place with the bond gauges, which are left *stripped out* of the
    network (Vidal form) — the caller owns reinsertion. If not
    supplied, the gauges are reabsorbed symmetrically at the end so the
    network's value is preserved, matching the reference. Returns
    ``tn``.
    """
    tn = self if inplace else self.copy()
    gauges_supplied = gauges is not None
    if not gauges_supplied:
        gauges = {}
    for it in range(max_iterations):
        max_sdiff = 0.0
        # renormalize each new gauge to unit norm, accruing the
        # stripped log10 scale into the network exponent — raw
        # singular values compound across sweeps and overflow f64 on
        # multi-layer networks otherwise
        info = {"max_sdiff": 0.0, "exponent": 0.0}
        for ix, tids in tuple(tn.ind_map.items()):
            if len(tids) != 2:
                continue
            tid1, tid2 = tuple(tids)
            tensor_gauge_simple_bond(
                tn.tensor_map[tid1], tn.tensor_map[tid2], gauges,
                smudge=smudge, power=power, damping=damping,
                renorm=True, info=info,
            )
        tn.exponent += info["exponent"]
        max_sdiff = info["max_sdiff"]
        if tol and max_sdiff < tol:
            break
    if not gauges_supplied:
        # reabsorb sqrt of each gauge into both tensors so the
        # network's value is unchanged (reference behavior)
        _tn_gauge_simple_insert(tn, gauges)
    return tn


def _tn_gauge_simple_insert(self, gauges, smudge=0.0, remove=False):
    """Absorb sqrt of each bond gauge into both its tensors; a gauge
    whose bond has only *one* tensor in this network (a dangling bond,
    e.g. of a local patch cut out of a larger gauged TN) is absorbed
    fully into that tensor, approximating the cut environment
    (reference ``gauge_simple_insert`` tensor_core.py:8071,8110)."""
    for ix, s in gauges.items():
        tids = tuple(self.ind_map.get(ix, ()))
        if not tids:
            continue
        if len(tids) == 1:
            g = s + smudge
            if remove:
                g = 1 / torch.where(g > 0, g, 1.0)
            self.tensor_map[tids[0]].multiply_index_diagonal_(ix, g)
            continue
        g = torch.sqrt(s + smudge)
        if remove:
            g = 1 / torch.where(g > 0, g, 1.0)
        for tid in tids:
            self.tensor_map[tid].multiply_index_diagonal_(ix, g)
    return self


def _tn_gauge_simple_remove(self, gauges, smudge=0.0):
    return _tn_gauge_simple_insert(self, gauges, smudge=smudge,
                                   remove=True)


class _GaugeSimpleTemp:
    def __init__(self, tn, gauges, smudge=0.0):
        self.tn, self.gauges, self.smudge = tn, gauges, smudge

    def __enter__(self):
        _tn_gauge_simple_insert(self.tn, self.gauges,
                                smudge=self.smudge)
        return self.tn

    def __exit__(self, *exc):
        _tn_gauge_simple_remove(self.tn, self.gauges,
                                smudge=self.smudge)


def _tn_gauge_simple_temp(self, gauges, smudge=0.0):
    """Context manager: temporarily absorb simple gauges (reference
    ``gauge_simple_temp``)."""
    return _GaugeSimpleTemp(self, gauges, smudge=smudge)


def _tn_gauge_all_bp(self, max_iterations=100, tol=5e-6,
                     inplace=False, **kwargs):
    """Gauge every bond with converged 1-norm BP message products
    (reference ``gauge_all_belief_propagation``
    tensor_core.py:7776): on each bond of two tensors, the diagonal gauge
    ``g = sqrt((|m2| + smudge) / (|m1| + smudge))`` and its inverse, which
    keep the network's value."""
    from .belief_propagation import D1BP

    tn = self if inplace else self.copy()
    bp = D1BP(tn, max_iterations=max_iterations, tol=tol, **kwargs)
    bp.run()
    for ix, tids in tuple(tn.ind_map.items()):
        if len(tids) != 2:
            continue
        tid1, tid2 = tuple(tids)
        m1 = bp.messages.get((ix, tid1))
        m2 = bp.messages.get((ix, tid2))
        if m1 is None or m2 is None:
            continue
        # symmetric (value-preserving) gauge: rotate the bond basis so
        # the two BP messages become equal
        smudge = 1e-12
        g = torch.sqrt((torch.abs(m2) + smudge) / (torch.abs(m1) + smudge))
        tn.tensor_map[tid1].multiply_index_diagonal_(ix, g)
        tn.tensor_map[tid2].multiply_index_diagonal_(ix, 1 / g)
    return tn


def _tn_gauge_all(self, method="canonize", **kwargs):
    """Dispatch bond gauging (reference ``gauge_all``)."""
    if method == "canonize":
        return self.gauge_all_canonize(**kwargs)
    if method == "simple":
        return self.gauge_all_simple(**kwargs)
    if method in ("bp", "belief_propagation"):
        return self.gauge_all_belief_propagation(**kwargs)
    if method == "random":
        return self.gauge_all_random(**kwargs)
    raise ValueError(f"unknown gauge method {method}")


def _tn_canonize_around(self, tags, which="all", inplace=False,
                        **opts):
    """Tree-canonize every bond pointing toward the tagged region
    (reference ``canonize_around`` tensor_core.py)."""
    from .networking import get_tree_span

    tn = self if inplace else self.copy()
    tids = list(tn._get_tids_from_tags(tags, which))
    for tid_out, tid_in, _ in get_tree_span(tn, tids=tids):
        if tid_out in tn.tensor_map and tid_in in tn.tensor_map:
            t1 = tn.tensor_map[tid_out]
            t2 = tn.tensor_map[tid_in]
            if bonds(t1, t2):
                tensor_canonize_bond(t1, t2, absorb="right")
    return tn


def _tn_contract_around(self, tags, which="all", max_bond=None,
                        cutoff=1e-10, inplace=False, **kwargs):
    """Compress-contract everything *except* the tagged region
    (reference ``contract_around``)."""
    from .networking import get_tree_span

    tn = self if inplace else self.copy()
    keep = set(tn._get_tids_from_tags(tags, which))
    merges = [
        (a, b) for (a, b, _) in get_tree_span(tn, tids=list(keep))
    ]
    # the span moves outer->inner (leaves first); contract each outer
    # tensor into its inner neighbour unless the neighbour is in the
    # kept region, in which case just compress the connecting bond
    for tid_out, tid_in in merges:
        if tid_out not in tn.tensor_map or tid_in not in tn.tensor_map:
            continue
        if tid_in in keep:
            if max_bond is not None:
                t1 = tn.tensor_map[tid_out]
                t2 = tn.tensor_map[tid_in]
                if bonds(t1, t2):
                    tensor_compress_bond(
                        t1, t2, max_bond=max_bond, cutoff=cutoff
                    )
            continue
        keep_inds = _pair_output_inds(tn, tid_out, tid_in)
        t1 = tn._pop_tensor(tid_out)
        t2 = tn.tensor_map[tid_in]
        new = tensor_contract(
            t1, t2, output_inds=tuple(keep_inds),
            preserve_tensor=True,
        )
        t2.modify(data=new.data, inds=new.inds,
                  tags=t2.tags | t1.tags)
        if max_bond is not None:
            for ix in tuple(t2.inds):
                holders = tuple(tn.ind_map.get(ix, ()))
                if len(holders) == 2 and t2.ind_size(ix) > max_bond:
                    other = next(h for h in holders if h != tid_in)
                    tensor_compress_bond(
                        tn.tensor_map[other], t2,
                        max_bond=max_bond, cutoff=cutoff,
                    )
    return tn


def _tn_contract_between(self, tags1, tags2, **contract_opts):
    """Contract the two tagged tensors into one (reference
    ``contract_between``)."""
    (tid1,) = self._get_tids_from_tags(tags1, "all")
    (tid2,) = self._get_tids_from_tags(tags2, "all")
    keep = _pair_output_inds(self, tid1, tid2)
    t1 = self._pop_tensor(tid1)
    t2 = self.tensor_map[tid2]
    new = tensor_contract(
        t1, t2, output_inds=tuple(keep), preserve_tensor=True,
        **contract_opts,
    )
    t2.modify(data=new.data, inds=new.inds, tags=t2.tags | t1.tags)


def _tn_contract_ind(self, ind, **contract_opts):
    """Contract all tensors sharing ``ind`` (reference
    ``contract_ind``)."""
    tids = tuple(self.ind_map.get(ind, ()))
    if len(tids) < 2:
        return
    first = tids[0]
    for other in tids[1:]:
        _tn_contract_between_tids(self, other, first,
                                  **contract_opts)


def _tn_contract_between_tids(self, tid1, tid2, **contract_opts):
    keep = _pair_output_inds(self, tid1, tid2)
    t1 = self._pop_tensor(tid1)
    t2 = self.tensor_map[tid2]
    new = tensor_contract(
        t1, t2, output_inds=tuple(keep), preserve_tensor=True,
        **contract_opts,
    )
    t2.modify(data=new.data, inds=new.inds, tags=t2.tags | t1.tags)


def _tn_replace_with_svd(self, where, left_inds, eps=None, which="any",
                         max_bond=None, ltags=None, rtags=None,
                         inplace=False, **split_opts):
    """Replace the tagged region with the two factors of its SVD
    across (left_inds | rest) (reference ``replace_with_svd``
    tensor_core.py:5913)."""
    tn = self if inplace else self.copy()
    tids = tuple(tn._get_tids_from_tags(where, which))
    region_ts = [tn._pop_tensor(tid) for tid in tids]
    region = tensor_contract(
        *region_ts, preserve_tensor=True,
        output_inds=tuple(dict.fromkeys(
            ix for t in region_ts for ix in t.inds
            if ix in tn.ind_map or sum(
                ix in t2.inds for t2 in region_ts
            ) == 1
        )),
    )
    if eps is not None and max_bond is None:
        split_opts.setdefault("cutoff", eps)
    tl, tr = region.split(
        left_inds=tuple(left_inds), get="tensors",
        max_bond=max_bond, ltags=ltags, rtags=rtags, **split_opts,
    )
    tn.add_tensor(tl, virtual=True)
    tn.add_tensor(tr, virtual=True)
    return tn


def _tn_insert_compressor_between_regions(
    self, ltags, rtags, max_bond=None, cutoff=1e-10, insert_into=None,
    new_ltags=None, new_rtags=None, inplace=False, **compress_opts,
):
    """Insert oblique projectors compressing the bonds between two
    tagged regions (reference ``insert_compressor_between_regions``
    tensor_core.py:9924 — the 'full-bond' / CTMRG-projector
    primitive). The projectors are *computed* from ``self``; when
    ``insert_into`` is given they are spliced into that network
    instead (so a frozen copy can supply the environments while the
    evolving network receives the compressors, as in CTMRG)."""
    if insert_into is not None:
        target = insert_into
    else:
        target = self if inplace else self.copy()
    tn = self
    ltids = tuple(tn._get_tids_from_tags(ltags, "any"))
    rtids = tuple(tn._get_tids_from_tags(rtags, "any"))
    # bonds between the regions
    bix = [
        ix for ix, tids in tn.ind_map.items()
        if any(t in ltids for t in tids)
        and any(t in rtids for t in tids)
    ]
    if not bix:
        raise ValueError("regions share no bonds")
    # reduced factors of each region onto the shared bonds
    lt = tensor_contract(
        *(tn.tensor_map[t] for t in ltids), preserve_tensor=True,
    )
    rt = tensor_contract(
        *(tn.tensor_map[t] for t in rtids), preserve_tensor=True,
    )
    l_other = [ix for ix in lt.inds if ix not in bix]
    r_other = [ix for ix in rt.inds if ix not in bix]
    Rl = lt.transpose(*l_other, *bix).data.reshape(
        int(np.prod([lt.ind_size(i) for i in l_other]) or 1), -1)
    Rr = rt.transpose(*bix, *r_other).data.reshape(
        int(np.prod([rt.ind_size(i) for i in bix])), -1)
    _, _, Rl = decomp.qr_stabilized(Rl)
    Lr, _, _ = decomp.lq_stabilized(Rr)
    Pl, Pr = decomp.compute_oblique_projectors(
        Rl, Lr, max_bond=max_bond, cutoff=cutoff, **compress_opts,
    )
    # splice the projector pair into the bonds of the target network
    bdims = [tn.ind_size(ix) for ix in bix]
    new_ix = rand_uuid()
    mid_l = [rand_uuid() for _ in bix]
    t_ltids = (
        ltids if target is tn
        else tuple(target._get_tids_from_tags(ltags, "any"))
    )
    for ix, mix in zip(bix, mid_l):
        for tid in tuple(target.ind_map[ix]):
            if tid in t_ltids:
                target.tensor_map[tid].reindex_({ix: mix})
    target.add_tensor(Tensor(
        Pl.reshape(*bdims, -1), inds=(*mid_l, new_ix),
        tags=tags_to_oset(new_ltags),
    ), virtual=True)
    target.add_tensor(Tensor(
        Pr.reshape(-1, *bdims), inds=(new_ix, *bix),
        tags=tags_to_oset(new_rtags),
    ), virtual=True)
    return target


def _tn_select_local(self, tags, which="all", max_distance=1,
                     virtual=True, **kwargs):
    """Select the tagged tensors plus everything within
    ``max_distance`` bonds (reference ``select_local``
    tensor_core.py:5579)."""
    from .networking import get_local_patch

    tids = list(self._get_tids_from_tags(tags, which))
    patch = get_local_patch(self, tids, max_distance=max_distance)
    ts = [self.tensor_map[t] for t in patch]
    return TensorNetwork(ts, virtual=virtual)


def _tn_as_network(self, virtual=True):
    return TensorNetwork(
        self.tensor_map.values(), virtual=virtual
    )


@classmethod
def _tn_from_TN(cls, tn, like=None, inplace=False, **kwargs):
    tn = tn if inplace else tn.copy()
    return tn.view_as_(cls, **kwargs)


@classmethod
def _tn_new(cls, like=None, **kwargs):
    obj = TensorNetwork(())
    return obj.view_as_(cls, **kwargs)


def _tn_combine(self, other, virtual=False, check_collisions=True):
    """Combine with another TN (reference ``combine``)."""
    new = self.copy(virtual=virtual)
    new.add_tensor_network(
        other if virtual else other.copy(),
        virtual=True, check_collisions=check_collisions,
    )
    return new


def _tn_check(self):
    """Assert internal map consistency (reference ``check``)."""
    for tid, t in self.tensor_map.items():
        for ix in t.inds:
            assert tid in self.ind_map.get(ix, ()), (tid, ix)
        for tag in t.tags:
            assert tid in self.tag_map.get(tag, ()), (tid, tag)
    for ix, tids in self.ind_map.items():
        for tid in tids:
            assert ix in self.tensor_map[tid].inds
    return True


# networking delegations
def _delegate_networking(name):
    def meth(self, *args, **kwargs):
        from . import networking

        return getattr(networking, name)(self, *args, **kwargs)

    meth.__name__ = name
    meth.__doc__ = f"Delegates to ``networking.{name}``."
    return meth


# simplify delegations
def _delegate_simplify(name):
    def meth(self, *args, inplace=False, **kwargs):
        from . import simplify

        return getattr(simplify, name)(
            self, *args, inplace=inplace, **kwargs
        )

    meth.__name__ = name
    meth.__doc__ = f"Delegates to ``simplify.{name}``."
    return meth


def _wire_parity_methods():
    TN = TensorNetwork
    TN.tags = property(_tn_tags)
    TN.item = _tn_item
    TN.iscomplex = _tn_iscomplex
    TN.dtype_name = property(_tn_dtype_name)
    TN.backend = property(_tn_backend)
    TN.outer_dims_inds = _tn_outer_dims_inds
    TN.outer_size = _tn_outer_size
    TN.get_multibonds = _tn_get_multibonds
    TN.get_hyperinds = _tn_get_hyperinds
    TN.get_symbol_map = _tn_get_symbol_map
    TN.get_equation = _tn_get_equation
    TN.get_inputs_output_size_dict = _tn_get_inputs_output_size_dict
    TN.make_tids_consecutive = _tn_make_tids_consecutive
    TN.tensors_sorted = _tn_tensors_sorted
    TN.randomize = _tn_randomize
    TN.randomize_ = functools.partialmethod(_tn_randomize,
                                            inplace=True)
    TN.convert_to_zero = _tn_convert_to_zero
    TN.to_qarray = _tn_to_qarray
    TN.sum_reduce = _tn_sum_reduce
    TN.sum_reduce_ = functools.partialmethod(_tn_sum_reduce,
                                             inplace=True)
    TN.vector_reduce = _tn_vector_reduce
    TN.vector_reduce_ = functools.partialmethod(_tn_vector_reduce,
                                                inplace=True)
    TN.cut_between = _tn_cut_between
    TN.cut_bond = _tn_cut_bond
    TN.insert_gauge = _tn_insert_gauge
    TN.insert_operator = _tn_insert_operator
    TN.insert_operator_ = functools.partialmethod(
        _tn_insert_operator, inplace=True
    )
    TN.new_bond = _tn_new_bond
    TN.expand_bond_dimension = _tn_expand_bond_dimension
    TN.expand_bond_dimension_ = functools.partialmethod(
        _tn_expand_bond_dimension, inplace=True
    )
    TN.compute_reduced_factor = _tn_compute_reduced_factor
    TN.isometrize = _tn_isometrize
    TN.isometrize_ = functools.partialmethod(_tn_isometrize,
                                             inplace=True)
    TN.unitize = _tn_isometrize
    TN.unitize_ = TN.isometrize_
    TN.balance_bonds = _tn_balance_bonds
    TN.balance_bonds_ = functools.partialmethod(_tn_balance_bonds,
                                                inplace=True)
    if not hasattr(TN, "make_norm"):
        TN.make_norm = _tn_make_norm
    TN.make_overlap = _tn_make_overlap
    TN.overlap = _tn_overlap
    TN.gauge_all_canonize = _tn_gauge_all_canonize
    TN.gauge_all_canonize_ = functools.partialmethod(
        _tn_gauge_all_canonize, inplace=True
    )
    if not hasattr(TN, "gauge_all_simple"):
        TN.gauge_all_simple = _tn_gauge_all_simple
        TN.gauge_all_simple_ = functools.partialmethod(
            _tn_gauge_all_simple, inplace=True
        )
    TN.gauge_simple_insert = _tn_gauge_simple_insert
    TN.gauge_simple_remove = _tn_gauge_simple_remove
    TN.gauge_simple_temp = _tn_gauge_simple_temp
    TN.gauge_all_belief_propagation = _tn_gauge_all_bp
    TN.gauge_all_belief_propagation_ = functools.partialmethod(
        _tn_gauge_all_bp, inplace=True
    )
    TN.gauge_all = _tn_gauge_all
    TN.gauge_all_ = functools.partialmethod(_tn_gauge_all,
                                            inplace=True)
    TN.canonize_around = _tn_canonize_around
    TN.canonize_around_ = functools.partialmethod(
        _tn_canonize_around, inplace=True
    )
    TN.contract_around = _tn_contract_around
    TN.contract_around_ = functools.partialmethod(
        _tn_contract_around, inplace=True
    )
    TN.contract_between = _tn_contract_between
    TN.contract_ind = _tn_contract_ind
    TN._contract_between_tids = _tn_contract_between_tids
    TN.replace_with_svd = _tn_replace_with_svd
    TN.replace_with_svd_ = functools.partialmethod(
        _tn_replace_with_svd, inplace=True
    )
    TN.insert_compressor_between_regions = \
        _tn_insert_compressor_between_regions
    TN.insert_compressor_between_regions_ = functools.partialmethod(
        _tn_insert_compressor_between_regions, inplace=True
    )
    TN.select_local = _tn_select_local
    TN.as_network = _tn_as_network
    TN.from_TN = _tn_from_TN
    TN.new = _tn_new
    TN.combine = _tn_combine
    TN.check = _tn_check
    TN.isblocksparse = lambda self: False
    TN.isfermionic = lambda self: False

    for name in (
        "istree", "isconnected", "subgraphs", "get_tree_span",
        "gen_loops", "gen_sloops", "gen_gloops", "gen_patches",
        "gen_paths_loops", "gen_inds_connected",
        "gen_all_paths_between_tids", "get_path_between_tids",
        "get_local_patch", "get_loop_union", "tids_are_connected",
        "compute_shortest_distances", "compute_centralities",
        "compute_hierarchical_linkage",
        "compute_hierarchical_ordering",
        "compute_hierarchical_grouping",
        "compute_hierarchical_ssa_path", "connected_bipartitions",
        "most_central_tid", "least_central_tid",
    ):
        if not hasattr(TN, name):
            setattr(TN, name, _delegate_networking(name))

    for name in (
        "diagonal_reduce", "antidiag_gauge", "column_reduce",
        "split_simplify", "pair_simplify", "loop_simplify",
        "hyperinds_resolve",
    ):
        setattr(TN, name, _delegate_simplify(name))
        setattr(TN, name + "_", functools.partialmethod(
            _delegate_simplify(name), inplace=True
        ))

    def compress_simplify(self, inplace=False, max_bond=8, **kwargs):
        """Simplify then cap every bond (reference
        ``compress_simplify``). A compression that fails raises."""
        tn = self if inplace else self.copy()
        tn.full_simplify_(**kwargs)
        for ix, tids in tuple(tn.ind_map.items()):
            if len(tids) == 2 and tn.ind_size(ix) > max_bond:
                t1, t2 = (tn.tensor_map[t] for t in tids)
                tensor_compress_bond(t1, t2, max_bond=max_bond)
        return tn

    TN.compress_simplify = compress_simplify
    TN.compress_simplify_ = functools.partialmethod(
        compress_simplify, inplace=True
    )

    def draw_tree_span(self, *args, **kwargs):
        return self.draw(*args, **kwargs)

    TN.draw_tree_span = draw_tree_span
    TN.graph_tree_span = draw_tree_span

    def draw_3d(self, *args, **kwargs):
        kwargs.setdefault("dim", 3)
        return self.draw(*args, **kwargs)

    def draw_interactive(self, *args, **kwargs):
        kwargs.setdefault("backend", "plotly")
        return self.draw(*args, **kwargs)

    def draw_3d_interactive(self, *args, **kwargs):
        kwargs.setdefault("dim", 3)
        kwargs.setdefault("backend", "plotly")
        return self.draw(*args, **kwargs)

    def visualize_tensors(self, mode="network", **kwargs):
        """Plot the entries of every tensor, arranged by the graph
        layout ('network') or tiled ('grid'/'row'/'col') (reference
        ``visualize_tensors`` drawing.py:1644)."""
        from .drawing import visualize_tensors

        return visualize_tensors(self, mode=mode, **kwargs)

    TN.draw_3d = draw_3d
    TN.draw_interactive = draw_interactive
    TN.draw_3d_interactive = draw_3d_interactive
    TN.visualize_tensors = visualize_tensors


_wire_parity_methods()


def _tensor_flip(self, ind, inplace=False):
    """Reverse the data along one index's axis (reference
    ``Tensor.flip`` tensor_core.py:3622); host numpy stays numpy."""
    if ind not in self.inds:
        raise ValueError(f"can't find index {ind}")
    t = self if inplace else self.copy()
    ax = t.inds.index(ind)
    if isinstance(t.data, np.ndarray):
        t.modify(apply=lambda x: np.flip(x, ax))
    else:
        t.modify(apply=lambda x: torch.flip(x, (ax,)))
    return t


Tensor.flip = _tensor_flip
Tensor.flip_ = functools.partialmethod(_tensor_flip, inplace=True)


# ---------------------------------------------------------------------------
# Tensor method parity layer
# ---------------------------------------------------------------------------

def _t_item(self):
    return self.data.item()


def _t_iscomplex(self):
    return "complex" in str(self.dtype)


def _t_astype(self, dtype, inplace=False):
    t = self if inplace else self.copy()
    t.modify(apply=lambda x: ar.astype(x, dtype))
    return t


def _t_to_qarray(self):
    """The data as a host numpy array (quimb_tpu wraps it in its
    ``qarray``, which the port does not have)."""
    return ar.to_host(self.data)


def _t_as_network(self, virtual=True):
    return TensorNetwork((self,), virtual=virtual)


def _t_apply_to_arrays(self, fn):
    self.modify(apply=fn)


def _t_check(self):
    assert len(self.inds) == ndim_of(self.data)
    return True


def ndim_of(x):
    return len(x.shape)


def _t_bonds(self, other):
    return bonds(self, other)


def _t_bonds_size(self, other):
    return bonds_size(self, other)


def _t_filter_bonds(self, other):
    """Split this tensor's inds into (shared, unshared) with another
    (reference ``filter_bonds``)."""
    shared = bonds(self, other)
    return (
        tuple(ix for ix in self.inds if ix in shared),
        tuple(ix for ix in self.inds if ix not in shared),
    )


def _t_new_bond(self, other, **opts):
    return new_bond(self, other, **opts)


def _t_contract(self, *others, **opts):
    return tensor_contract(self, *others, **opts)


def _t_direct_product(self, other, sum_inds=(), inplace=False):
    return tensor_direct_product(
        self, other, sum_inds=sum_inds, inplace=inplace
    )


def _t_negate(self, inplace=False):
    t = self if inplace else self.copy()
    t.modify(apply=lambda x: -x)
    return t


def _t_overlap(self, other, **kwargs):
    """``<other|self>`` treating both as vectors over their (matching)
    indices."""
    o = other.conj().transpose_like(self) if isinstance(
        other, Tensor
    ) else other
    return (o.data * self.data).sum()


def _t_distance(self, other):
    """||self - other|| of two tensors on matching indices (the helper of
    ``distance_normalized``; ``Tensor.distance`` goes through fitting.py,
    not ported yet)."""
    d2 = (
        (abs(self.data) ** 2).sum()
        + (abs(other.data) ** 2).sum()
        - 2 * _t_overlap(self, other).real
    )
    return d2.real.clip(0.0, None) ** 0.5


def _t_distance_normalized(self, other, **kwargs):
    na = (abs(self.data) ** 2).sum() ** 0.5
    nb = (abs(other.data) ** 2).sum() ** 0.5
    a = self.copy()
    a.modify(apply=lambda x: x / na)
    b = other.copy()
    b.modify(apply=lambda x: x / nb)
    return _t_distance(a, b)


def _t_inds_size(self, inds):
    out = 1
    for ix in inds:
        out *= self.ind_size(ix)
    return out


def _t_idxmax(self, f=None):
    """Coordinate map of the maximum element (reference ``idxmax``
    tensor_core.py:3407)."""
    data = self.data
    if callable(f):
        data = f(data)
    elif isinstance(f, str):
        data = getattr(torch, f)(data)
    flat = int(torch.argmax(data.real))
    coo = np.unravel_index(flat, self.shape)
    return dict(zip(self.inds, map(int, coo)))


def _t_idxmin(self, f=None):
    data = self.data
    if callable(f):
        data = f(data)
    elif isinstance(f, str):
        data = getattr(torch, f)(data)
    flat = int(torch.argmin(data.real))
    coo = np.unravel_index(flat, self.shape)
    return dict(zip(self.inds, map(int, coo)))


def _t_singular_values(self, left_inds, method="svd"):
    """Singular values across a bipartition (reference
    ``singular_values``)."""
    left_inds = asinds(left_inds)
    right_inds = tuple(
        ix for ix in self.inds if ix not in left_inds
    )
    m = self.inds_size(left_inds)
    mat = self.transpose(*left_inds, *right_inds).data.reshape(m, -1)
    return decomp.safe_svd(mat)[1]


def _t_entropy(self, left_inds, method="svd"):
    """Von Neumann entropy of the bipartition (reference
    ``Tensor.entropy``)."""
    s = _t_singular_values(self, left_inds, method=method)
    # some split drivers (e.g. eig on complex input) hand back the
    # values in a complex container — the spectrum itself is real
    p = (s * torch.conj(s)).real
    p = p / torch.sum(p)
    p = torch.where(p > 1e-300, p, 1.0)
    return -torch.sum(p * torch.log2(p))


def _t_rand_reduce(self, ind, dtype=None, seed=None, inplace=False):
    """Contract a random vector into ``ind`` (reference
    ``rand_reduce`` tensor_core.py:2926)."""
    from ..gen.rand import randn

    t = self if inplace else self.copy()
    v = randn((t.ind_size(ind),), dtype=dtype or t.dtype, seed=seed,
              device=t.data.device)
    data = array_contract([t.data, v], [t.inds, (ind,)],
                          tuple(ix for ix in t.inds if ix != ind))
    t.modify(data=data, inds=tuple(
        ix for ix in t.inds if ix != ind
    ))
    return t


def _t_collapse_repeated(self, inplace=False):
    """Take the diagonal over any repeated indices (reference
    ``collapse_repeated`` tensor_core.py:2950)."""
    from ..ops.contraction import array_contract

    t = self if inplace else self.copy()
    old = t.inds
    new = tuple(dict.fromkeys(old))
    if len(old) == len(new):
        return t
    data = array_contract([t.data], [old], output=new)
    t.modify(data=data, inds=new)
    return t


def _t_symmetrize(self, ind1, ind2, inplace=False):
    """Symmetrize over a pair of same-size indices (reference
    ``symmetrize_``)."""
    t = self if inplace else self.copy()
    ax1, ax2 = t.inds.index(ind1), t.inds.index(ind2)
    t.modify(apply=lambda x: (x + torch.swapaxes(x, ax1, ax2)) / 2)
    return t


def _t_new_ind_with_identity(self, name, left_inds, right_inds,
                             axis=0):
    """Add a new size-2 index whose value-1 slice is the identity
    from ``left_inds`` to ``right_inds`` (reference
    ``new_ind_with_identity`` tensor_core.py:2458). Inplace."""
    left_inds = asinds(left_inds)
    right_inds = asinds(right_inds)
    d = int(np.prod([self.ind_size(ix) for ix in left_inds]))
    dev = self.data.device
    ident = torch.eye(d, dtype=self.dtype, device=dev).reshape(
        tuple(self.ind_size(ix) for ix in left_inds)
        + tuple(self.ind_size(ix) for ix in right_inds),
    )
    # broadcast into the full index order of self
    order = {ix: i for i, ix in enumerate(
        (*left_inds, *right_inds)
    )}
    ones = [
        torch.ones((self.ind_size(ix),), dtype=self.dtype, device=dev)
        for ix in self.inds if ix not in order
    ]
    ident_t = array_contract(
        [ident, *ones],
        [(*left_inds, *right_inds),
         *[(ix,) for ix in self.inds if ix not in order]],
        output=self.inds,
    )
    stacked = torch.stack([self.data, ident_t], dim=axis)
    self.modify(
        data=stacked,
        inds=(*self.inds[:axis], name, *self.inds[axis:]),
    )
    return self


def _t_new_ind_pair_with_identity(self, new_left_ind, new_right_ind,
                                  d, inplace=False):
    """Outer-product with a d-dim identity, adding the two new
    indices at the front (reference ``new_ind_pair_with_identity``
    tensor_core.py:2486)."""
    t = self if inplace else self.copy()
    ident = torch.eye(d, dtype=t.dtype, device=t.data.device)
    data = torch.tensordot(ident, t.data, dims=0)
    t.modify(data=data,
             inds=(new_left_ind, new_right_ind, *t.inds))
    return t


def _t_new_ind_pair_diag(self, ind, new_left_ind, new_right_ind,
                         inplace=False):
    """Turn index ``ind`` into a diagonal pair of indices, inserted at
    the position of ``ind`` (reference ``new_ind_pair_diag``
    tensor_core.py:2531 — the docstring example there shows the pair
    replacing the old index in place, not appended)."""
    from ..ops.contraction import array_contract

    t = self if inplace else self.copy()
    d = t.ind_size(ind)
    diag3 = torch.zeros((d, d, d), dtype=t.dtype, device=t.data.device)
    ar_d = torch.arange(d, device=t.data.device)
    diag3[ar_d, ar_d, ar_d] = 1.0
    ax = t.inds.index(ind)
    new_inds = (
        t.inds[:ax] + (new_left_ind, new_right_ind) + t.inds[ax + 1:]
    )
    new_data = array_contract(
        [t.data, diag3],
        [t.inds, (ind, new_left_ind, new_right_ind)],
        output=new_inds,
    )
    t.modify(data=new_data, inds=new_inds)
    return t


def _t_get_params(self):
    return self.data


def _t_set_params(self, params):
    self.modify(data=params)


def _wire_tensor_parity():
    T = Tensor
    T.item = _t_item
    T.iscomplex = _t_iscomplex
    T.dtype_name = property(lambda self: str(self.dtype))
    T.backend = property(lambda self: "torch")
    T.get_namespace = lambda self: torch
    T.isblocksparse = lambda self: False
    T.isfermionic = lambda self: False
    T.astype = _t_astype
    T.astype_ = functools.partialmethod(_t_astype, inplace=True)
    T.to_qarray = _t_to_qarray
    T.as_network = _t_as_network
    T.apply_to_arrays = _t_apply_to_arrays
    T.check = _t_check
    T.bonds = _t_bonds
    T.bonds_size = _t_bonds_size
    T.filter_bonds = _t_filter_bonds
    T.new_bond = _t_new_bond
    T.contract = _t_contract
    T.direct_product = _t_direct_product
    T.direct_product_ = functools.partialmethod(
        _t_direct_product, inplace=True
    )
    T.negate = _t_negate
    T.negate_ = functools.partialmethod(_t_negate, inplace=True)
    T.overlap = _t_overlap
    T.distance_normalized = _t_distance_normalized
    T.inds_size = _t_inds_size
    T.idxmax = _t_idxmax
    T.idxmin = _t_idxmin
    T.singular_values = _t_singular_values
    T.entropy = _t_entropy
    T.rand_reduce = _t_rand_reduce
    T.rand_reduce_ = functools.partialmethod(
        _t_rand_reduce, inplace=True
    )
    T.collapse_repeated = _t_collapse_repeated
    T.collapse_repeated_ = functools.partialmethod(
        _t_collapse_repeated, inplace=True
    )
    T.symmetrize = _t_symmetrize
    T.symmetrize_ = functools.partialmethod(
        _t_symmetrize, inplace=True
    )
    T.new_ind_with_identity = _t_new_ind_with_identity
    T.new_ind_pair_with_identity = _t_new_ind_pair_with_identity
    T.new_ind_pair_with_identity_ = functools.partialmethod(
        _t_new_ind_pair_with_identity, inplace=True
    )
    T.new_ind_pair_diag = _t_new_ind_pair_diag
    T.new_ind_pair_diag_ = functools.partialmethod(
        _t_new_ind_pair_diag, inplace=True
    )
    T.get_params = _t_get_params
    T.set_params = _t_set_params
    T.compute_reduced_factor = _tn_compute_reduced_factor
    def _t_visualize(self, **kwargs):
        """Plot this tensor's entries: magnitude -> size, phase -> hue
        (reference ``Tensor.visualize`` / ``visualize_tensor``
        drawing.py)."""
        from .drawing import visualize_tensor

        return visualize_tensor(self, **kwargs)

    T.visualize = _t_visualize


_wire_tensor_parity()


# remaining TensorNetwork wiring
def _tn_get_namespace(self):
    return torch


def _tn_get_tid_neighbor_map(self):
    from .networking import tn_adjacency

    return {
        tid: oset(nbrs) for tid, nbrs in tn_adjacency(self).items()
    }


def _tn_compute_contracted_inds(self, *tids, output_inds=None):
    """The indices a contraction of ``tids`` would produce (reference
    ``compute_contracted_inds``)."""
    if output_inds is None:
        output_inds = set(self.outer_inds())
    else:
        output_inds = set(output_inds)
    tids = set(tids)
    keep = []
    seen = set()
    for tid in tids:
        for ix in self.tensor_map[tid].inds:
            if ix in seen:
                continue
            seen.add(ix)
            holders = self.ind_map.get(ix, ())
            outside = any(t not in tids for t in holders)
            if outside or ix in output_inds:
                keep.append(ix)
    return tuple(keep)


def _tn_select_path(self, path, virtual=True):
    """The tensors along a :class:`NetworkPath` as a TN (reference
    ``select_path``)."""
    return TensorNetwork(
        [self.tensor_map[tid] for tid in path.tids], virtual=virtual
    )


def _tn_split(self, left_inds, right_inds=None, **split_opts):
    """Decompose the whole network across a bipartition of its outer
    indices (reference ``TensorNetwork.split``
    tensor_core.py:9796)."""
    t = self.contract(
        ..., output_inds=tuple(self.outer_inds()),
        preserve_tensor=True,
    )
    return tensor_split(
        t, left_inds=left_inds, right_inds=right_inds, **split_opts
    )


def _tn_fit_(self, tn_target, **kwargs):
    fitted = self.fit(tn_target, **kwargs)
    for t_self, t_fit in zip(
        self.tensor_map.values(), fitted.tensor_map.values()
    ):
        # the fit may have permuted axes — align to this tensor's
        # index order before writing the data back
        t_self.modify(data=t_fit.transpose(*t_self.inds).data)
    return self


def _tn_gauge_local(self, tags, which="all", max_distance=1,
                    max_iterations=1, method="canonize",
                    inplace=False, **kwargs):
    """Gauge only the bonds within a local patch (reference
    ``gauge_local``)."""
    from .networking import get_local_patch

    tn = self if inplace else self.copy()
    tids = list(tn._get_tids_from_tags(tags, which))
    patch = set(get_local_patch(tn, tids,
                                max_distance=max_distance))
    for _ in range(max_iterations):
        for ix, holders in tuple(tn.ind_map.items()):
            hs = tuple(holders)
            if len(hs) == 2 and all(h in patch for h in hs):
                if method == "canonize":
                    tensor_canonize_bond(
                        tn.tensor_map[hs[0]], tn.tensor_map[hs[1]],
                        absorb="right",
                    )
    return tn


def _tn_compress_all_simple(self, max_bond=None, cutoff=1e-10,
                            max_iterations=5, inplace=False,
                            **kwargs):
    """Compress every bond using the simple-update gauge (reference
    ``compress_all_simple``)."""
    tn = self if inplace else self.copy()
    gauges = {}
    tn2 = tn.gauge_all_simple(
        max_iterations=max_iterations, gauges=gauges
    )
    tn2.gauge_simple_insert(gauges)
    for ix, tids in tuple(tn2.ind_map.items()):
        ts = tuple(tids)
        if len(ts) == 2 and (
            max_bond is None or tn2.ind_size(ix) > max_bond
        ):
            tensor_compress_bond(
                tn2.tensor_map[ts[0]], tn2.tensor_map[ts[1]],
                max_bond=max_bond, cutoff=cutoff,
            )
    return tn2


def _tn_compress_all_tree(self, max_bond=None, cutoff=1e-10,
                          inplace=False, **kwargs):
    """Canonize toward the most central tensor along a spanning tree,
    then compress back outwards (reference ``compress_all_tree``)."""
    from .networking import get_tree_span, most_central_tid

    tn = self if inplace else self.copy()
    root = most_central_tid(tn)
    span = get_tree_span(tn, tids=[root])
    # canonize inwards (leaves first)
    for tid_out, tid_in, _ in span:
        t1, t2 = tn.tensor_map[tid_out], tn.tensor_map[tid_in]
        if bonds(t1, t2):
            tensor_canonize_bond(t1, t2, absorb="right")
    # compress outwards (root first)
    for tid_out, tid_in, _ in reversed(span):
        t1, t2 = tn.tensor_map[tid_out], tn.tensor_map[tid_in]
        if bonds(t1, t2):
            tensor_compress_bond(
                t2, t1, max_bond=max_bond, cutoff=cutoff
            )
    return tn


def _tn_compress_all_1d(self, max_bond=None, cutoff=1e-10,
                        inplace=False, **kwargs):
    """1D-chain sweep compression via the dedicated 1D machinery when
    site structure exists, else the tree scheme (reference
    ``compress_all_1d``)."""
    if hasattr(self, "site_tags"):
        from .tn1d.compress import tensor_network_1d_compress

        return tensor_network_1d_compress(self, max_bond=max_bond,
                                          cutoff=cutoff, **kwargs)
    return _tn_compress_all_tree(self, max_bond=max_bond, cutoff=cutoff,
                                 inplace=inplace, **kwargs)


def _tn_contract_around_center(self, **kwargs):
    from .networking import most_central_tid

    tid = most_central_tid(self)
    tags = tuple(self.tensor_map[tid].tags)
    return self.contract_around(
        tags if tags else (), which="any", **kwargs
    )


def _tn_contract_around_corner(self, **kwargs):
    from .networking import compute_centralities

    cents = compute_centralities(self)
    tid = min(cents, key=cents.get)
    tags = tuple(self.tensor_map[tid].tags)
    return self.contract_around(
        tags if tags else (), which="any", **kwargs
    )


def _tn_reduce_inds_onto_bond(self, inda, indb, tags=None,
                              drop_tags=False, combine=True,
                              ndim_cutoff=3):
    """QR-reduce ``inda`` and ``indb`` onto the bond between their
    tensors, optionally combining the reduced factors into one bond
    tensor (reference ``reduce_inds_onto_bond``
    tensor_core.py:7032). Inplace."""
    (tida,) = self.ind_map[inda]
    (tidb,) = self.ind_map[indb]
    ta, tb = self.tensor_map[tida], self.tensor_map[tidb]
    shared = list(bonds(ta, tb))
    new_parts = []
    for t, ind in ((ta, inda), (tb, indb)):
        if t.ndim <= ndim_cutoff:
            continue
        keep_left = [
            ix for ix in t.inds if ix != ind and ix not in shared
        ]
        q, _, r = decomp.array_split(
            t.transpose(*keep_left, ind, *shared).data.reshape(
                int(np.prod([t.ind_size(i) for i in keep_left]) or 1),
                -1),
            method="qr", cutoff=-1.0,
        )
        bnd = rand_uuid()
        ldims = [t.ind_size(i) for i in keep_left]
        # read before ``t`` drops ``ind`` and the bond (quimb_tpu reads
        # them from the network after, and raises KeyError)
        rdims = [t.ind_size(i) for i in (ind, *shared)]
        t.modify(
            data=q.reshape(*ldims, q.shape[-1]),
            inds=(*keep_left, bnd),
        )
        rt = Tensor(
            r.reshape(r.shape[0], *rdims),
            inds=(bnd, ind, *shared),
            tags=tags_to_oset(tags),
        )
        new_parts.append(rt)
        self.add_tensor(rt, virtual=True)
    if combine and len(new_parts) == 2:
        t1, t2 = new_parts
        tid1 = next(
            tid for tid, t in self.tensor_map.items() if t is t1
        )
        tid2 = next(
            tid for tid, t in self.tensor_map.items() if t is t2
        )
        self._contract_between_tids(tid1, tid2)
    return self


def _tn_drape_bond_between(self, tagsa, tagsb, tags_target,
                           left_ind=None, right_ind=None,
                           inplace=False):
    """Reroute the bond between two tensors so it passes through a
    third (reference ``drape_bond_between`` tensor_core.py:8938)."""
    tn = self if inplace else self.copy()
    (tida,) = tn._get_tids_from_tags(tagsa, "all")
    (tidb,) = tn._get_tids_from_tags(tagsb, "all")
    (tidt,) = tn._get_tids_from_tags(tags_target, "all")
    ta, tb = tn.tensor_map[tida], tn.tensor_map[tidb]
    tt = tn.tensor_map[tidt]
    (ix,) = bonds(ta, tb)
    d = ta.ind_size(ix)
    if left_ind is None:
        left_ind = ix
    elif left_ind != ix:
        ta.reindex_({ix: left_ind})
    if right_ind is None:
        right_ind = rand_uuid()
    elif right_ind == left_ind:
        raise ValueError("right_ind cannot be the same as left_ind")
    tb.reindex_({ix: right_ind})
    # the target picks up the identity pair connecting a -(left)- t
    # and t -(right)- b
    tt.new_ind_pair_with_identity_(left_ind, right_ind, d)
    return tn


def _tn_gate_inds_with_tn(self, inds, gate, gate_inds_inner,
                          gate_inds_outer, inplace=False):
    """Gate some indices with another TN whose ``gate_inds_inner``
    contract with them, leaving ``gate_inds_outer`` (reference
    ``gate_inds_with_tn``)."""
    tn = self if inplace else self.copy()
    gate = gate.copy()
    reindex = {}
    for ix, gi, go in zip(inds, gate_inds_inner, gate_inds_outer):
        mid = rand_uuid()
        tn.reindex_({ix: mid})
        reindex[gi] = mid
        reindex[go] = ix
    gate.reindex_(reindex)
    tn.add_tensor_network(gate, virtual=True,
                          check_collisions=False)
    return tn


def _wire_tn_parity2():
    TN = TensorNetwork
    TN.get_namespace = _tn_get_namespace
    TN.get_tid_neighbor_map = _tn_get_tid_neighbor_map
    TN.compute_contracted_inds = _tn_compute_contracted_inds
    TN.select_path = _tn_select_path
    TN.split = _tn_split
    TN.fit_ = _tn_fit_
    TN.gauge_local = _tn_gauge_local
    TN.gauge_local_ = functools.partialmethod(_tn_gauge_local,
                                              inplace=True)
    TN.compress_all_simple = _tn_compress_all_simple
    TN.compress_all_simple_ = functools.partialmethod(
        _tn_compress_all_simple, inplace=True
    )
    TN.compress_all_tree = _tn_compress_all_tree
    TN.compress_all_tree_ = functools.partialmethod(
        _tn_compress_all_tree, inplace=True
    )
    TN.compress_all_1d = _tn_compress_all_1d
    TN.compress_all_1d_ = functools.partialmethod(
        _tn_compress_all_1d, inplace=True
    )
    TN.contract_around_center = _tn_contract_around_center
    TN.contract_around_corner = _tn_contract_around_corner
    TN.reduce_inds_onto_bond = _tn_reduce_inds_onto_bond
    TN.drape_bond_between = _tn_drape_bond_between
    TN.drape_bond_between_ = functools.partialmethod(
        _tn_drape_bond_between, inplace=True
    )
    TN.gate_inds_with_tn = _tn_gate_inds_with_tn
    TN.gate_inds_with_tn_ = functools.partialmethod(
        _tn_gate_inds_with_tn, inplace=True
    )
    TN.flip = lambda self, inds, inplace=False: _tn_flip(
        self, inds, inplace=inplace
    )
    TN.flip_ = functools.partialmethod(
        lambda self, inds, inplace=False: _tn_flip(
            self, inds, inplace=inplace
        ), inplace=True,
    )

    def replace_section_with_svd(self, start, stop, eps=None,
                                 **kwargs):
        """1D form: replace the sites in ``[start, stop)`` with their
        SVD across the section boundary (reference
        ``replace_section_with_svd``)."""
        tags = [self.site_tag(i) for i in range(start, stop)]
        sec = self.select(tags, which="any")
        outer_left = [
            ix for ix in sec.outer_inds()
            if any(
                tid not in sec.tensor_map
                for tid in self.ind_map.get(ix, ())
            ) and min(
                i for i in range(start, stop)
            ) is not None
        ]
        # left inds: the bonds crossing the `start` boundary
        left_tags = self.site_tag(start)
        lt = self.select(left_tags, which="any")
        left_inds = [
            ix for ix in lt.all_inds()
            if ix in sec.outer_inds()
        ]
        return self.replace_with_svd(
            tags, left_inds=left_inds, eps=eps, which="any", **kwargs
        )

    TN.replace_section_with_svd = replace_section_with_svd


def _tn_flip(self, inds, inplace=False):
    """Flip data along the given indices everywhere they appear
    (reference ``TensorNetwork.flip``)."""
    tn = self if inplace else self.copy()
    if isinstance(inds, str):
        inds = (inds,)
    for ix in inds:
        for tid in tn.ind_map.get(ix, ()):
            tn.tensor_map[tid].flip_(ix)
    return tn


_wire_tn_parity2()
