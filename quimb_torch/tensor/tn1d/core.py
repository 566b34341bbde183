"""1D tensor networks as objects: the site-tagged base class, its
one-index-per-site vector form and the open-chain MPS.

Port of the parts of quimb_tpu's ``tensor/tn1d/core.py`` that the circuit
simulator needs (reference ``quimb/tensor/tn1d/core.py``:
``TensorNetwork1D`` :~200, ``MatrixProductState`` :1670): integer sites
tagged ``site_tag_id``, the site indices ``site_ind_id``, and
``MatrixProductState.__init__`` for open chains. The canonical forms,
gating, expectations, cyclic chains and the MPO come with ROADMAP item
14(b); the DMRG and TEBD engines keep sweeping the ``(l, p, r)`` lists of
``tn1d/builders.py``.
"""

import functools

import numpy as np

from ...utils import oset
from ..core import Tensor, TensorNetwork, bonds, rand_uuid, tags_to_oset


class TensorNetwork1D(TensorNetwork):
    """Base for 1D networks: integer sites, ``site_tag_id`` tagging."""

    _EXTRA_PROPS = ("_site_tag_id", "_L")
    _CONTRACT_STRUCTURED = True

    @property
    def L(self):
        return self._L

    @property
    def nsites(self):
        return self._L

    @property
    def cyclic(self):
        """Whether this network has periodic boundary conditions,
        detected as a direct bond between the first and last sites."""
        if self._L <= 2:
            return False
        try:
            t0 = self[self.site_tag(0)]
            tL = self[self.site_tag(self._L - 1)]
        except KeyError:
            return False
        if isinstance(t0, TensorNetwork) or isinstance(tL, TensorNetwork):
            return False
        return bool(bonds(t0, tL))

    @property
    def site_tag_id(self):
        return self._site_tag_id

    def site_tag(self, i):
        return self._site_tag_id.format(i % self._L)

    @property
    def site_tags(self):
        return tuple(self.site_tag(i) for i in self.gen_site_coos())

    def gen_site_coos(self):
        return range(self._L)

    @property
    def sites(self):
        return tuple(self.gen_site_coos())

    def maybe_convert_coo(self, x):
        """Allow integer and slice site indexing."""
        if isinstance(x, (int, np.integer)):
            return self.site_tag(x)
        if isinstance(x, slice):
            start = 0 if x.start is None else x.start
            stop = self._L if x.stop is None else x.stop
            return tuple(map(self.site_tag, range(start, stop)))
        return x

    def slice2sites(self, tag_slice):
        start = 0 if tag_slice.start is None else tag_slice.start
        stop = self._L if tag_slice.stop is None else tag_slice.stop
        return tuple(range(start, stop))

    def contract_structured(self, tag_slice=None, output_inds=None,
                            inplace=False, **opts):
        """Contract sites left-to-right (the structured 1D path)."""
        tn = self if inplace else self.copy()
        if tag_slice is None:
            tag_slice = slice(0, self._L)
        sites = self.slice2sites(tag_slice)
        result = tn
        for i in sites:
            tag = self.site_tag(i)
            if tag not in result.tag_map:
                continue
            result = result.contract_tags_(
                tags_to_oset(tag), which="any", **opts
            ) if isinstance(result, TensorNetwork) else result
            if not isinstance(result, TensorNetwork):
                return result
        if isinstance(result, TensorNetwork) and result.num_tensors > 1:
            return result.contract_tags_(None, which="any", **opts)
        if isinstance(result, TensorNetwork) and result.num_tensors == 1:
            (t,) = result.tensor_map.values()
            if not t.inds:
                return t.data * 10 ** result.exponent \
                    if result.exponent else t.data
        return result


class TensorNetwork1DVector(TensorNetwork1D):
    """1D networks with one physical ('site') index per site."""

    _EXTRA_PROPS = ("_site_tag_id", "_site_ind_id", "_L")

    def make_norm(self, layer_tags=("KET", "BRA")):
        """The <psi|psi> sandwich network with the two layers tagged."""
        ket = self.copy()
        ket.add_tag(layer_tags[0])
        bra = ket.H
        bra.retag_({layer_tags[0]: layer_tags[1]})
        bra.mangle_inner_("*")
        norm = ket & bra
        norm.view_like_(self)
        return norm

    @property
    def site_ind_id(self):
        return self._site_ind_id

    def site_ind(self, i):
        return self._site_ind_id.format(i % self._L)

    @property
    def site_inds(self):
        return tuple(self.site_ind(i) for i in self.gen_site_coos())

    def phys_dim(self, i=0):
        return self.ind_size(self.site_ind(i))

    def reindex_sites(self, new_id, where=None, inplace=False):
        where = range(self._L) if where is None else where
        tn = self.reindex(
            {self.site_ind(i): new_id.format(i) for i in where},
            inplace=inplace,
        )
        tn._site_ind_id = new_id
        return tn

    reindex_sites_ = functools.partialmethod(reindex_sites, inplace=True)

    def to_dense(self, *inds_seq, **contract_opts):
        if not inds_seq:
            inds_seq = (self.site_inds,)
        t = super().to_dense(*inds_seq, **contract_opts)
        return t.reshape(-1, 1) if t.ndim == 1 else t


class MatrixProductState(TensorNetwork1DVector):
    """Open-chain matrix product state (reference ``MatrixProductState``
    tn1d/core.py:1670). Arrays follow the ``shape`` convention (default
    'lrp'); the end sites omit the missing bond."""

    _EXTRA_PROPS = ("_site_tag_id", "_site_ind_id", "_L")

    def __init__(self, arrays, *, shape="lrp", tags=None,
                 site_ind_id="k{}", site_tag_id="I{}", cyclic=False,
                 **tn_opts):
        if isinstance(arrays, MatrixProductState):
            super().__init__(arrays)
            return
        if cyclic:
            raise NotImplementedError(
                "cyclic MatrixProductState is not ported to quimb_torch "
                "yet: ROADMAP item 14(b)"
            )
        arrays = tuple(arrays)
        self._L = len(arrays)
        self._site_ind_id = site_ind_id
        self._site_tag_id = site_tag_id
        tags = tags_to_oset(tags)

        bond_inds = [rand_uuid() for _ in range(self._L - 1)]
        tensors = []
        for i, arr in enumerate(arrays):
            order = [c for c in shape if not (
                (i == 0 and c == "l") or (i == self._L - 1 and c == "r")
            )]
            inds = []
            for c in order:
                if c == "l":
                    inds.append(bond_inds[i - 1])
                elif c == "r":
                    inds.append(bond_inds[i])
                else:
                    inds.append(site_ind_id.format(i))
            tensors.append(Tensor(
                arr, inds=inds,
                tags=tags | oset((site_tag_id.format(i),)),
            ))
        super().__init__(tensors, virtual=True, **tn_opts)
