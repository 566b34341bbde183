"""Generic isometric / MERA-like tensor network builder on arbitrary
geometry (reference ``quimb/experimental/merabuilder/merabuilder.py``).

Starting from bare ``sites``, one layers unitaries (disentanglers,
sites stay open), isometries (coarse-grain a block of open sites into
one), and finally caps (close remaining sites) — building e.g. TTNs,
MERAs, or isometric PEPS-like states on any graph. Tensors carry
``left_inds`` so ``isometrize()`` projects every layer onto the
isometric manifold.

Port of quimb_tpu's ``experimental/merabuilder.py`` on the port's
``tnag/``. Random layers draw from numpy's ``default_rng``, as quimb_tpu's
do, so both packages build the same network from one seed; a host array
goes to ``device`` (the GPU unless given).
"""

import numpy as np
import torch

from ..ops.backend import resolve_device, to_device
from ..tensor.core import Tensor, TensorNetwork, rand_uuid
from ..tensor.tnag.core import TensorNetworkGenVector
from ..utils import oset

__all__ = ["TensorNetworkGenIso", "TTN_randtree_rand"]


class TensorNetworkGenIso(TensorNetworkGenVector):
    """Layered isometric TN on arbitrary sites."""

    _EXTRA_PROPS = ("_sites", "_site_tag_id", "_site_ind_id")

    @classmethod
    def empty(cls, sites, phys_dim=2, site_ind_id="k{}",
              site_tag_id="I{}", device=None):
        obj = object.__new__(cls)
        TensorNetwork.__init__(obj, ())
        obj._device = resolve_device(device)
        obj._sites = tuple(sites)
        obj._site_ind_id = site_ind_id
        obj._site_tag_id = site_tag_id
        obj._phys_dim = phys_dim
        obj._open = {s: obj.site_ind(s) for s in obj._sites}
        obj._open_dims = {s: phys_dim for s in obj._sites}
        # lightcone tags: which site tags each new tensor inherits
        obj._cone = {s: oset((obj.site_tag(s),)) for s in obj._sites}
        obj._nlayer = 0
        return obj

    # -- layering ----------------------------------------------------------

    def _array(self, G):
        """``G`` as a tensor: tensors stay where they are, host arrays go
        to the network's device."""
        if isinstance(G, torch.Tensor):
            return G
        return to_device(G, device=getattr(self, "_device", None)
                         or resolve_device(None))

    def _take(self, where):
        lows = [self._open[s] for s in where]
        dims = [self._open_dims[s] for s in where]
        tags = oset()
        for s in where:
            tags |= self._cone[s]
        return lows, dims, tags

    def layer_unitary(self, G, where, tags=None):
        """Place a unitary (disentangler) above ``where``; all sites
        stay open with fresh indices."""
        lows, dims, cone = self._take(where)
        ups = [rand_uuid() for _ in where]
        t = Tensor(
            self._array(G).reshape(tuple(dims) * 2),
            inds=(*ups, *lows),
            tags=cone | oset(("UNI", f"_LAYER{self._nlayer}"))
            | oset(tags or ()),
            left_inds=tuple(ups),
        )
        self.add_tensor(t)
        for s, ix in zip(where, ups):
            self._open[s] = ix
        return self

    def layer_isometry(self, G, where, new_site=None, dim=None,
                       tags=None):
        """Coarse-grain the open block ``where`` into the single open
        site ``new_site`` (default ``where[0]``) of dimension ``dim``."""
        lows, dims, cone = self._take(where)
        new_site = where[0] if new_site is None else new_site
        if dim is None:
            dim = int(np.prod(dims))
        up = rand_uuid()
        t = Tensor(
            self._array(G).reshape(*dims, dim),
            inds=(*lows, up),
            tags=cone | oset(("ISO", f"_LAYER{self._nlayer}"))
            | oset(tags or ()),
            left_inds=tuple(lows),
        )
        self.add_tensor(t)
        for s in where:
            del self._open[s]
            del self._open_dims[s]
        self._open[new_site] = up
        self._open_dims[new_site] = dim
        self._cone[new_site] = cone
        return self

    def layer_cap(self, G, where=None, tags=None):
        """Close the remaining (or given) open sites with a top
        tensor."""
        where = tuple(self._open) if where is None else tuple(where)
        lows, dims, cone = self._take(where)
        t = Tensor(
            self._array(G).reshape(tuple(dims)),
            inds=tuple(lows),
            tags=cone | oset(("TOP", f"_LAYER{self._nlayer}"))
            | oset(tags or ()),
        )
        self.add_tensor(t)
        for s in where:
            del self._open[s]
            del self._open_dims[s]
        return self

    def next_layer(self):
        self._nlayer += 1
        return self

    # -- random layering ---------------------------------------------------

    def layer_unitary_rand(self, where, seed=None, **kwargs):
        _, dims, _ = self._take(where)
        d = int(np.prod(dims))
        rng = np.random.default_rng(seed)
        Q, _ = np.linalg.qr(rng.standard_normal((d, d)))
        return self.layer_unitary(Q.reshape(*dims, *dims), where,
                                  **kwargs)

    def layer_isometry_rand(self, where, dim, seed=None, **kwargs):
        _, dims, _ = self._take(where)
        d = int(np.prod(dims))
        dim = min(dim, d)
        rng = np.random.default_rng(seed)
        Q, _ = np.linalg.qr(rng.standard_normal((d, dim)))
        return self.layer_isometry(Q.reshape(*dims, dim), where,
                                   dim=dim, **kwargs)

    def layer_cap_rand(self, where=None, seed=None, **kwargs):
        where = tuple(self._open) if where is None else tuple(where)
        _, dims, _ = self._take(where)
        rng = np.random.default_rng(seed)
        v = rng.standard_normal(int(np.prod(dims)))
        v /= np.linalg.norm(v)
        return self.layer_cap(v.reshape(tuple(dims)), where, **kwargs)

    # -- isometric projection ----------------------------------------------

    def isometrize(self, method="qr", inplace=False):
        """Project every layered tensor onto the isometric manifold
        (left_inds-aware); cap/tree tensors are normalized."""
        tn = self if inplace else self.copy()
        for t in tn:
            if t.left_inds:
                t.isometrize_(left_inds=t.left_inds, method=method)
            elif "TOP" in t.tags:
                nrm = float(t.norm())
                if nrm > 0:
                    t.modify(apply=lambda d, nrm=nrm: d / nrm)
        return tn

    def isometrize_(self, **kwargs):
        return self.isometrize(inplace=True, **kwargs)


def TTN_randtree_rand(sites, max_bond, phys_dim=2, group_size=2,
                      seed=None, iso=True, device=None):
    """Random tree tensor network: repeatedly coarse-grain groups of
    ``group_size`` open sites with random isometries until one block
    remains, then cap (reference ``TTN_randtree_rand``
    merabuilder.py:807)."""
    rng = np.random.default_rng(seed)
    tn = TensorNetworkGenIso.empty(sites, phys_dim=phys_dim, device=device)
    while len(tn._open) > group_size:
        open_sites = list(tn._open)
        rng.shuffle(open_sites)
        for k in range(0, len(open_sites) - group_size + 1, group_size):
            grp = tuple(open_sites[k:k + group_size])
            tn.layer_isometry_rand(
                grp, max_bond, seed=int(rng.integers(2**31))
            )
        tn.next_layer()
    tn.layer_cap_rand(seed=int(rng.integers(2**31)))
    if iso:
        tn.isometrize_()
    return tn


# ---------------------------------------------------------------------------
# parity extras (reference merabuilder.py:80-240, 539)
# ---------------------------------------------------------------------------

def _tngi_layer_ind_id(self):
    """The format of per-layer open index labels."""
    return getattr(self, "_layer_ind_id", "__layer_{}__")


def _tngi_layer_ind(self, site):
    """The current open (top) index above ``site``."""
    if site in self._open:
        return self._open[site]
    return self.layer_ind_id.format(site)


def _tngi_layer_gate_raw(self, G, where, iso=True, new_sites=None,
                         tags=None, all_site_tags=None):
    """Place a raw tensor ``G`` at ``where``: dispatches on its shape
    to unitary (ndim == 2*len(where)), isometry/tree (one new open
    index) or cap (no new index) placement (reference
    ``layer_gate_raw`` merabuilder.py:86)."""
    G = self._array(G)
    k = G.ndim - len(where)
    if k == len(where):
        return self.layer_unitary(G, tuple(where), tags=tags)
    if k == 1:
        new_site = None if new_sites is None else new_sites[0]
        return self.layer_isometry(
            G, tuple(where), new_site=new_site,
            dim=G.shape[-1], tags=tags,
        )
    if k == 0:
        return self.layer_cap(G, tuple(where), tags=tags)
    raise ValueError(
        f"array with {G.ndim} dims doesn't match {len(where)} sites"
    )


def _tngi_layer_gate_fill_fn(self, fill_fn, operation, where,
                             max_bond, new_sites=None, tags=None,
                             all_site_tags=None):
    """Place a new tensor at ``where`` with data from
    ``fill_fn(shape)`` (reference ``layer_gate_fill_fn``
    merabuilder.py:199). ``operation`` is one of
    {'uni', 'iso', 'tree', 'cap', 'treecap'}."""
    dims = [self._open_dims[s] for s in where]
    if operation == "uni":
        shape = (*dims, *dims)
        return self.layer_unitary(fill_fn(shape), tuple(where),
                                  tags=tags)
    if operation in ("iso", "tree"):
        dim = min(max_bond, int(np.prod(dims)))
        shape = (*dims, dim)
        new_site = None if new_sites is None else new_sites[0]
        return self.layer_isometry(
            fill_fn(shape), tuple(where), new_site=new_site, dim=dim,
            tags=tags,
        )
    if operation in ("cap", "treecap"):
        return self.layer_cap(fill_fn(tuple(dims)), tuple(where),
                              tags=tags)
    raise ValueError(f"unknown operation {operation!r}")


def calc_1d_unis_isos(sites, block_size=2, cyclic=True,
                      group_from_right=False):
    """The (unitary, isometry) site groupings of one 1D MERA layer
    (reference ``calc_1d_unis_isos`` merabuilder.py:539)."""
    n = len(sites)
    unis = []
    if n > 2:
        for i in range(n // block_size):
            a = (block_size * i + 1) % n
            b = (block_size * i + 2) % n
            if a < n and (b != 0 or cyclic):
                unis.append((sites[a], sites[b % n]))
    isos = []
    for i in range(0, n - block_size + 1, block_size):
        isos.append(tuple(sites[i:i + block_size]))
    return unis, isos


TensorNetworkGenIso.layer_ind_id = property(_tngi_layer_ind_id)
TensorNetworkGenIso.layer_ind = _tngi_layer_ind
TensorNetworkGenIso.layer_gate_raw = _tngi_layer_gate_raw
TensorNetworkGenIso.layer_gate_fill_fn = _tngi_layer_gate_fill_fn
