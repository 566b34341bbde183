"""1D tensor networks: MPS, MPO, canonical forms, expectations, sampling.

Port of quimb_tpu's ``tensor/tn1d/core.py`` (reference
``quimb/tensor/tn1d/core.py``: ``TensorNetwork1D`` :~200,
``TensorNetwork1DFlat`` :815, ``MatrixProductState`` :1670,
``MatrixProductOperator`` :3946, ``Dense1D`` :4467, ``gate_TN_1D`` :98,
``expec_TN_1D`` :55).

The arrays are torch tensors on one device; every method runs there. The
host is read where the result is a host number (an entropy, a norm, the
probabilities a sample draws from with ``np.random.default_rng``).

``expec_TN_1D`` contracts the sandwich from the left, one tensor at a
time: an environment absorbs the site's ket, operator(s) and bra in turn,
so no intermediate exceeds the environment times one site tensor.
quimb_tpu's version merges each site's column first; a bra and a ket site
share only the physical index, so that column is an outer product over the
bonds, chi^4 entries (ROADMAP §3).
"""

import functools
import math

import numpy as np
import torch

from ...ops import decomp
from ...ops.backend import resolve_device, to_device, to_host
from ...utils import oset
from .. import array_ops as ar
from ..core import (
    Tensor,
    TensorNetwork,
    _deferred,
    bonds,
    rand_uuid,
    tags_to_oset,
    tensor_canonize_bond,
    tensor_compress_bond,
    tensor_contract,
)


def _tn_device(tn):
    """The device of the first tensor of ``tn``."""
    return next(iter(tn.tensor_map.values())).data.device


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

    def gate(self, G, where, contract=False, **opts):
        return gate_TN_1D(self, G, where, contract=contract, **opts)

    gate_ = functools.partialmethod(gate, inplace=True)

    def expec(self, *args, **kwargs):
        return expec_TN_1D(*args, **kwargs)

    def correlation(self, A, i, j, B=None, **expec_opts):
        """<psi|A_i B_j|psi> / <psi|psi>."""
        B = A if B is None else B
        bra = self.H
        kA = self.gate(A, i, contract=True)
        kAB = kA.gate(B, j, contract=True)
        norm = expec_TN_1D(bra, self)
        return expec_TN_1D(bra, kAB) / norm


class TensorNetwork1DOperator(TensorNetwork1D):
    _EXTRA_PROPS = ("_site_tag_id", "_upper_ind_id", "_lower_ind_id", "_L")

    @property
    def upper_ind_id(self):
        return self._upper_ind_id

    @property
    def lower_ind_id(self):
        return self._lower_ind_id

    def upper_ind(self, i):
        return self._upper_ind_id.format(i % self._L)

    def lower_ind(self, i):
        return self._lower_ind_id.format(i % self._L)

    @property
    def upper_inds(self):
        return tuple(map(self.upper_ind, self.gen_site_coos()))

    @property
    def lower_inds(self):
        return tuple(map(self.lower_ind, self.gen_site_coos()))

    def phys_dim(self, i=0):
        return self.ind_size(self.upper_ind(i))

    def reindex_upper_sites(self, new_id, where=None, inplace=False):
        where = range(self._L) if where is None else where
        tn = self.reindex(
            {self.upper_ind(i): new_id.format(i) for i in where},
            inplace=inplace,
        )
        tn._upper_ind_id = new_id
        return tn

    def reindex_lower_sites(self, new_id, where=None, inplace=False):
        where = range(self._L) if where is None else where
        tn = self.reindex(
            {self.lower_ind(i): new_id.format(i) for i in where},
            inplace=inplace,
        )
        tn._lower_ind_id = new_id
        return tn

    reindex_lower_sites_ = functools.partialmethod(
        reindex_lower_sites, inplace=True
    )
    reindex_upper_sites_ = functools.partialmethod(
        reindex_upper_sites, inplace=True
    )

    def to_dense(self, *inds_seq, **contract_opts):
        if not inds_seq:
            inds_seq = (self.upper_inds, self.lower_inds)
        return super().to_dense(*inds_seq, **contract_opts)


class TensorNetwork1DFlat(TensorNetwork1D):
    """Canonical forms and compression of flat (one tensor a site)
    networks (reference tn1d/core.py:815)."""

    def bond(self, i, j):
        (b,) = bonds(self[self.site_tag(i)], self[self.site_tag(j)])
        return b

    def bond_size(self, i, j):
        return self[self.site_tag(i)].ind_size(self.bond(i, j))

    def bond_sizes(self):
        return [self.bond_size(i, i + 1) for i in range(self._L - 1)]

    def _sync_bra(self, bra, *sites):
        """Give ``bra``'s tensors at ``sites`` the conjugate data of this
        network's."""
        for s in sites:
            t = self[self.site_tag(s)]
            bra[self.site_tag(s)].modify(data=ar.do_conj(t.data),
                                         inds=t.inds)

    def left_canonize_site(self, i, bra=None):
        """QR site i, absorbing R into site i+1."""
        tensor_canonize_bond(self[self.site_tag(i)],
                             self[self.site_tag(i + 1)], absorb="right")
        if bra is not None:
            self._sync_bra(bra, i, i + 1)

    def right_canonize_site(self, i, bra=None):
        """LQ site i, absorbing L into site i-1."""
        tensor_canonize_bond(self[self.site_tag(i)],
                             self[self.site_tag(i - 1)], absorb="right")
        if bra is not None:
            self._sync_bra(bra, i, i - 1)

    def left_canonize(self, stop=None, start=None, normalize=False,
                      bra=None):
        """Left-canonize all sites in [start, stop)."""
        start = 0 if start is None else start
        stop = self._L - 1 if stop is None else stop
        for i in range(start, stop):
            self.left_canonize_site(i, bra=bra)
        if normalize:
            self[self.site_tag(self._L - 1)].normalize_()
            if bra is not None:
                self._sync_bra(bra, self._L - 1)

    def right_canonize(self, stop=None, start=None, normalize=False,
                       bra=None):
        start = self._L - 1 if start is None else start
        stop = 0 if stop is None else stop
        for i in range(start, stop, -1):
            self.right_canonize_site(i, bra=bra)
        if normalize:
            self[self.site_tag(0)].normalize_()
            if bra is not None:
                self._sync_bra(bra, 0)

    def canonize(self, where, cur_orthog="calc", bra=None):
        """Mixed-canonize: orthogonality center at site(s) ``where``.
        Like quimb_tpu, every call sweeps the whole chain from both ends
        (``cur_orthog`` is accepted and not read)."""
        if isinstance(where, (int, np.integer)):
            i = j = int(where)
        else:
            i, j = min(where), max(where)
        self.left_canonize(stop=i, bra=bra)
        self.right_canonize(stop=j, bra=bra)
        return self

    canonize_cyclic = canonize

    def shift_orthogonality_center(self, current, new, bra=None):
        if new > current:
            for i in range(current, new):
                self.left_canonize_site(i, bra=bra)
        else:
            for i in range(current, new, -1):
                self.right_canonize_site(i, bra=bra)

    def calc_current_orthog_center(self, atol=1e-10):
        """The (left, right) sites bounding the non-canonical region."""
        lo = 0
        while lo < self._L - 1 and self._site_is_left_canonical(lo, atol):
            lo += 1
        hi = self._L - 1
        while hi > 0 and self._site_is_right_canonical(hi, atol):
            hi -= 1
        return (min(lo, hi), max(lo, hi))

    def _is_isometry(self, t, lix, rix, left, atol):
        t = t.transpose(*lix, *rix)
        nl = int(np.prod([t.ind_size(ix) for ix in lix]))
        mat = t.data.reshape(nl, -1)
        g = decomp.dag(mat) @ mat if left else mat @ decomp.dag(mat)
        eye = torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
        return bool(torch.allclose(g, eye, atol=atol, rtol=1e-5))

    def _site_is_left_canonical(self, i, atol=1e-10):
        t = self[self.site_tag(i)]
        rix = (bonds(t, self[self.site_tag(i + 1)])
               if i < self._L - 1 else oset())
        lix = [ix for ix in t.inds if ix not in rix]
        return self._is_isometry(t, lix, list(rix), True, atol)

    def _site_is_right_canonical(self, i, atol=1e-10):
        t = self[self.site_tag(i)]
        lix = bonds(t, self[self.site_tag(i - 1)]) if i > 0 else oset()
        rix = [ix for ix in t.inds if ix not in lix]
        return self._is_isometry(t, list(lix), rix, False, atol)

    def compress_site(self, i, canonize=True, cur_orthog="calc",
                      bra=None, **compress_opts):
        if canonize:
            self.canonize(i, bra=bra)
        if i > 0:
            tensor_compress_bond(
                self[self.site_tag(i - 1)], self[self.site_tag(i)],
                absorb="right", **compress_opts,
            )
        if i < self._L - 1:
            tensor_compress_bond(
                self[self.site_tag(i)], self[self.site_tag(i + 1)],
                absorb="left", **compress_opts,
            )

    def compress(self, form=None, **compress_opts):
        """Sweep-compress the whole chain into canonical ``form``
        ('left', 'right', or an int site)."""
        if form is None:
            form = "right"
        if form == "left" or form == 0:
            self.right_canonize()
            for i in range(self._L - 1):
                tensor_compress_bond(
                    self[self.site_tag(i)], self[self.site_tag(i + 1)],
                    absorb="right", **compress_opts,
                )
        elif form == "right" or form == self._L - 1:
            self.left_canonize()
            for i in range(self._L - 1, 0, -1):
                tensor_compress_bond(
                    self[self.site_tag(i - 1)], self[self.site_tag(i)],
                    absorb="left", **compress_opts,
                )
        elif isinstance(form, int):
            self.compress("right", **compress_opts)
            self.canonize(form)
        else:
            raise ValueError(f"invalid form {form}")
        return self

    def expand_bond_dimension(self, new_bond_dim, rand_strength=0.0,
                              inplace=True):
        """Pad all bonds up to ``new_bond_dim``."""
        tn = self if inplace else self.copy()
        for i in range(tn._L - 1):
            b = tn.bond(i, i + 1)
            if tn.bond_size(i, i + 1) < new_bond_dim:
                for s in (i, i + 1):
                    tn[tn.site_tag(s)].expand_ind(
                        b, new_bond_dim, rand_strength=rand_strength)
        return tn

    def amplitude(self, b):
        """Amplitude <b|psi> of a computational basis configuration."""
        psi = self.copy()
        for i, bi in enumerate(b):
            psi[psi.site_tag(i)].isel_({psi.site_ind(i): int(bi)})
        return psi.contract(...)


# ---------------------------------------------------------------------------
# MPS
# ---------------------------------------------------------------------------


def _site_bonds(tn, i, cyc):
    """(left bond, right bond) of site ``i``, ``None`` where missing."""
    L = tn._L
    t = tn[tn.site_tag(i)]
    lb = rb = None
    if i > 0 or cyc:
        lb_set = bonds(tn[tn.site_tag((i - 1) % L)], t)
        lb = next(iter(lb_set)) if lb_set else None
    if i < L - 1 or cyc:
        rb_set = bonds(t, tn[tn.site_tag((i + 1) % L)])
        rb = next(iter(rb_set)) if rb_set else None
    if L == 2 and lb is not None and lb == rb:
        # two sites share one bond: the right bond of site 0, the left
        # bond of site 1
        if i == 0:
            lb = None
        else:
            rb = None
    return lb, rb


def _direct_sum_1d_arrays(x, y, phys_inds_fn):
    """Direct-sum the site arrays of two 1D networks over their bonds
    (``A + B``): bond axes stack block-diagonally, missing end axes are
    shared. Returns (arrays in 'lr<phys>' layout, cyclic)."""
    L = x._L
    if y._L != L:
        raise ValueError("length mismatch in 1D direct sum")
    cyc = x.cyclic
    if y.cyclic != cyc:
        raise ValueError("cannot add open and cyclic networks")

    arrays = []
    for i in range(L):
        t1 = x[x.site_tag(i)]
        t2 = y[y.site_tag(i)]
        lb1, rb1 = _site_bonds(x, i, cyc)
        lb2, rb2 = _site_bonds(y, i, cyc)
        A1 = t1.transpose(*(ix for ix in (lb1, rb1) if ix is not None),
                          *phys_inds_fn(x, i)).data
        A2 = t2.transpose(*(ix for ix in (lb2, rb2) if ix is not None),
                          *phys_inds_fn(y, i)).data
        has_l, has_r = lb1 is not None, rb1 is not None
        pdims = tuple(t1.ind_size(ix) for ix in phys_inds_fn(x, i))
        l1 = t1.ind_size(lb1) if has_l else 1
        r1 = t1.ind_size(rb1) if has_r else 1
        l2 = t2.ind_size(lb2) if has_l else 1
        r2 = t2.ind_size(rb2) if has_r else 1
        dtype = torch.promote_types(A1.dtype, A2.dtype)
        A1 = A1.reshape(l1, r1, *pdims).to(dtype)
        A2 = A2.to(A1.device).reshape(l2, r2, *pdims).to(dtype)
        new = torch.zeros((l1 + l2 if has_l else 1,
                           r1 + r2 if has_r else 1) + pdims,
                          dtype=dtype, device=A1.device)
        sl1 = (slice(0, l1) if has_l else slice(None),
               slice(0, r1) if has_r else slice(None))
        sl2 = (slice(l1, l1 + l2) if has_l else slice(None),
               slice(r1, r1 + r2) if has_r else slice(None))
        new[sl1] = A1
        # += keeps L == 1 (both axes shared) summing; for a present bond
        # axis the two blocks are disjoint anyway
        new[sl2] += A2
        if not has_l:
            new = new[0]
        if not has_r:
            new = new[0] if not has_l else new[:, 0]
        arrays.append(new)
    return arrays, cyc


def _lrp_order(shape, i, L, cyclic):
    """The layout chars of site ``i``: the end sites of an open chain drop
    their missing bond."""
    return [c for c in shape if cyclic or not (
        (i == 0 and c == "l") or (i == L - 1 and c == "r"))]


class MatrixProductState(TensorNetwork1DVector, TensorNetwork1DFlat):
    """Matrix product state (reference ``MatrixProductState``
    tn1d/core.py:1670). Arrays follow the ``shape`` convention (default
    'lrp'); the end sites of an open chain omit the missing bond."""

    _EXTRA_PROPS = ("_site_tag_id", "_site_ind_id", "_L")

    def __init__(self, arrays, *, shape="lrp", tags=None,
                 site_ind_id="k{}", site_tag_id="I{}", cyclic=False,
                 **tn_opts):
        if isinstance(arrays, MatrixProductState):
            super().__init__(arrays)
            return
        arrays = tuple(arrays)
        self._L = len(arrays)
        self._site_ind_id = site_ind_id
        self._site_tag_id = site_tag_id
        tags = tags_to_oset(tags)

        # on a cyclic chain ``bond_inds[-1]`` is the wrap bond between
        # sites L-1 and 0
        nb = self._L if cyclic else self._L - 1
        bond_inds = [rand_uuid() for _ in range(nb)]
        tensors = []
        for i, arr in enumerate(arrays):
            inds = []
            for c in _lrp_order(shape, i, self._L, cyclic):
                if c == "l":
                    inds.append(bond_inds[i - 1])
                elif c == "r":
                    inds.append(bond_inds[i])
                else:
                    inds.append(site_ind_id.format(i))
            tensors.append(Tensor(
                arr, inds=inds, tags=tags | oset((site_tag_id.format(i),)),
            ))
        super().__init__(tensors, virtual=True, **tn_opts)

    @classmethod
    def from_dense(cls, psi, dims=2, site_ind_id="k{}", site_tag_id="I{}",
                   device=None, **split_opts):
        """An MPS of the dense state vector ``psi`` by successive SVDs
        (reference tn1d/core.py:1896), on ``device``."""
        psi = to_device(psi, device=resolve_device(device)).reshape(-1)
        if isinstance(dims, int):
            L = int(round(math.log(psi.numel(), dims)))
            dims = (dims,) * L
        L = len(dims)
        split_opts.setdefault("cutoff", 1e-12)
        arrays = []
        rem = psi.reshape(1, -1)
        chi_l = 1
        for i in range(L - 1):
            d = dims[i]
            U, _, sVH = decomp.array_split(
                rem.reshape(chi_l * d, -1), method="svd", absorb="right",
                **split_opts,
            )
            chi_r = U.shape[-1]
            arrays.append(U.reshape(chi_l, d, chi_r))
            rem = sVH
            chi_l = chi_r
        arrays.append(rem.reshape(chi_l, dims[-1], 1))
        # built (l, p, r); the constructor takes 'lrp' without end bonds
        mps_arrays = []
        for i, a in enumerate(arrays):
            if i == 0:
                a = a[0].transpose(0, 1)
            elif i == L - 1:
                a = a[..., 0]
            else:
                a = a.permute(0, 2, 1)
            mps_arrays.append(a)
        return cls(mps_arrays, shape="lrp", site_ind_id=site_ind_id,
                   site_tag_id=site_tag_id)

    def log_norm(self):
        """log(<psi|psi>)/2, by a transfer chain rescaled at every site
        (no overflow for long chains). The scales stay on the device: the
        host reads the result once."""
        if self.cyclic:
            n2 = complex(expec_TN_1D(self.H, self))
            return 0.5 * math.log(abs(n2))
        log_acc = 0.0
        env = None
        for i, A in enumerate(_mps_uniform_arrays(self)):
            if env is None:
                env = torch.einsum("apr,aps->rs", ar.do_conj(A), A)
            else:
                T = torch.einsum("ab,apr->bpr", env, ar.do_conj(A))
                env = torch.einsum("bpr,bps->rs", T, A)
            nrm = torch.linalg.norm(env.reshape(-1))
            env = env / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
            log_acc = log_acc + torch.log(nrm)
        log_acc = log_acc + torch.log(torch.abs(torch.trace(env)) + 1e-300)
        return float(log_acc) / 2

    def normalize(self, insert=None):
        """Normalize in place, returning the old norm. The factor is
        spread over every site (log space, no overflow)."""
        ln = self.log_norm()
        if insert is None:
            f = math.exp(-ln / self._L)
            for i in range(self._L):
                self[self.site_tag(i)].modify(apply=lambda d, f=f: d * f)
        else:
            f = math.exp(-ln)
            self[self.site_tag(insert)].modify(apply=lambda d, f=f: d * f)
        return math.exp(ln) if abs(ln) < 700 else float("inf")

    normalize_ = normalize

    def gate_split(self, G, where, inplace=False, **compress_opts):
        """Apply a 2-site gate and split back at once (the TEBD move,
        reference ``gate_split`` tn1d/core.py:2052)."""
        from ..gating import tensor_network_gate_inds

        psi = self if inplace else self.copy()
        i, j = where
        adjacent = abs(j - i) == 1 or (
            {i % self._L, j % self._L} == {0, self._L - 1} and self.cyclic)
        if not adjacent:
            raise ValueError("gate_split needs (cyclically) neighbouring "
                             "sites")
        compress_opts.setdefault("contract", "reduce-split")
        tensor_network_gate_inds(
            psi, G, (psi.site_ind(i), psi.site_ind(j)), inplace=True,
            **compress_opts,
        )
        return psi

    gate_split_ = functools.partialmethod(gate_split, inplace=True)

    def gate_with_auto_swap(self, G, where, inplace=False, cur_orthog=None,
                            **compress_opts):
        """A 2-site gate on any two sites: swap them adjacent, gate, and
        swap back (reference tn1d/core.py:2210)."""
        psi = self if inplace else self.copy()
        i, j = sorted(where)
        swap_seq = list(range(j, i + 1, -1))
        SWAP = _swap_gate(psi.phys_dim(i), psi.dtype, _tn_device(psi))
        for s in swap_seq:
            psi.gate_split_(SWAP, (s - 1, s), **compress_opts)
        psi.gate_split_(G, (i, i + 1), **compress_opts)
        for s in reversed(swap_seq):
            psi.gate_split_(SWAP, (s - 1, s), **compress_opts)
        return psi

    gate_with_auto_swap_ = functools.partialmethod(
        gate_with_auto_swap, inplace=True
    )

    def gate_with_submpo(self, submpo, where=None, inplace=False,
                         compress=True, max_bond=None, cutoff=1e-10):
        """Apply an MPO on the contiguous sites ``where`` (default the
        first ``submpo.L``), zipped in site by site, then compress the
        touched bonds (reference ``gate_with_submpo`` tn1d/core.py:2295)."""
        psi = self if inplace else self.copy()
        mpo = submpo.copy()
        mpo.mangle_inner_()
        L = mpo._L
        sites = tuple(range(L) if where is None else where)
        if len(sites) != L or any(b - a != 1
                                  for a, b in zip(sites, sites[1:])):
            raise ValueError("where must be contiguous, len == submpo.L")
        # wire: mpo lower <- mps phys; mpo upper -> mps phys
        for k, s in enumerate(sites):
            tmp = rand_uuid()
            psi[psi.site_tag(s)].reindex_({psi.site_ind(s): tmp})
            mpo[mpo.site_tag(k)].reindex_({
                mpo.lower_ind(k): tmp, mpo.upper_ind(k): psi.site_ind(s),
            })
        for k, s in enumerate(sites):
            t_ps = psi[psi.site_tag(s)]
            new = tensor_contract(t_ps, mpo[mpo.site_tag(k)],
                                  preserve_tensor=True)
            t_ps.modify(data=new.data, inds=new.inds)
        _fuse_pair_bonds([psi[psi.site_tag(s)] for s in sites])
        if compress:
            for a, b in zip(sites, sites[1:]):
                psi.compress_between(psi.site_tag(a), psi.site_tag(b),
                                     max_bond=max_bond, cutoff=cutoff)
        return psi

    gate_with_submpo_ = functools.partialmethod(
        gate_with_submpo, inplace=True
    )

    def magnetization(self, i, direction="Z"):
        from ...gen.operators import pauli

        G = pauli(direction, dtype=torch.complex128, device=_tn_device(self))
        if not self.dtype.is_complex and direction.upper() != "Y":
            G = G.real
        bra = self.H
        ket = self.gate(G.to(self.dtype), i, contract=True)
        return expec_TN_1D(bra, ket) / expec_TN_1D(bra, self)

    def add_MPS(self, other, compress=False, **compress_opts):
        """``|self> + |other>`` by bond direct sum, open or cyclic."""
        arrays, cyc = _direct_sum_1d_arrays(
            self, other, lambda tn, i: (tn.site_ind(i),))
        new = MatrixProductState(
            arrays, shape="lrp", cyclic=cyc, site_ind_id=self.site_ind_id,
            site_tag_id=self.site_tag_id,
        )
        if compress:
            new.compress(**compress_opts)
        return new

    def __add__(self, other):
        return self.add_MPS(other)

    def __sub__(self, other):
        return self.add_MPS(other.multiply(-1))

    def schmidt_values(self, i, cur_orthog=None, method="svd"):
        """Squared Schmidt values across the bond (i - 1, i), descending,
        as a tensor (reference tn1d/core.py:2588)."""
        if i == 0:
            raise ValueError("need i >= 1")
        self.canonize(i)
        t = self[self.site_tag(i)]
        left_bond = self.bond(i - 1, i)
        other = [ix for ix in t.inds if ix != left_bond]
        mat = t.transpose(left_bond, *other).data.reshape(
            t.ind_size(left_bond), -1)
        return torch.linalg.svdvals(mat) ** 2

    def entropy(self, i, cur_orthog=None):
        """Von Neumann entanglement entropy, in bits, across (i-1, i)."""
        S = self.schmidt_values(i, cur_orthog=cur_orthog)
        S = S[S > 1e-16]
        return float(-torch.sum(S * torch.log2(S)))

    def schmidt_gap(self, i, cur_orthog=None):
        S = self.schmidt_values(i, cur_orthog=cur_orthog)
        return float(S[0] - S[1])

    def partial_trace_linop(self, keep, upper_ind_id="b{}"):
        raise _deferred(16, "MatrixProductState.partial_trace_linop "
                            "(linop.py)")

    def partial_trace(self, keep, upper_ind_id="b{}", rescale_sites=True):
        """Reduced density matrix of sites ``keep``, dense."""
        bra = self.H
        kix = [self.site_ind(i) for i in keep]
        bix = [upper_ind_id.format(i) for i in keep]
        bra.reindex_({self.site_ind(i): upper_ind_id.format(i)
                      for i in keep})
        rho = (self & bra).contract(..., output_inds=tuple(kix) + tuple(bix))
        d = int(np.prod([self.phys_dim(i) for i in keep]))
        return rho.data.reshape(d, d)

    ptr = partial_trace

    def measure(self, site, remove=False, outcome=None, renorm=True,
                seed=None, inplace=False):
        """Measure a site in the computational basis (reference
        tn1d/core.py:3684). Returns (outcome, post-measurement state)."""
        psi = self if inplace else self.copy()
        psi.canonize(site)
        t = psi[psi.site_tag(site)]
        ind = psi.site_ind(site)
        d = psi.phys_dim(site)
        other = [ix for ix in t.inds if ix != ind]
        tt = t.transpose(ind, *other)
        probs = to_host(torch.sum(torch.abs(tt.data.reshape(d, -1)) ** 2,
                                  dim=1)).astype(np.float64)
        probs = probs / probs.sum()
        if outcome is None:
            outcome = int(np.random.default_rng(seed).choice(d, p=probs))
        if remove:
            t.isel_({ind: outcome})
        else:
            proj = torch.zeros(d, dtype=tt.data.dtype,
                               device=tt.data.device)
            proj[outcome] = 1.0
            t.modify(data=ar_multiply_axis(tt.data, proj, 0), inds=tt.inds)
        if renorm:
            f = 1 / math.sqrt(probs[outcome])
            t.modify(apply=lambda x: x * f)
        return outcome, psi

    measure_ = functools.partialmethod(measure, inplace=True)

    def sample(self, C, seed=None, info=None):
        """``C`` samples in the computational basis by exact sequential
        sampling (reference tn1d/core.py:3822); yields (config, omega),
        omega the probability. Each site's probabilities are read to the
        host, where ``np.random.default_rng(seed)`` draws."""
        psi = self.copy()
        psi.canonize(0)
        rng = np.random.default_rng(seed)
        for _ in range(C):
            yield self._sample_one(psi, rng)

    def _sample_one(self, psi, rng):
        config = []
        omega = 1.0
        env = None
        for i, A in enumerate(_mps_uniform_arrays(psi)):
            d = A.shape[1]
            A = A[0] if env is None else torch.tensordot(env, A, dims=1)
            Am = A.reshape(d, -1)
            probs = to_host(torch.sum(torch.abs(Am) ** 2, dim=1))
            probs = probs / probs.sum()
            b = int(rng.choice(d, p=probs))
            config.append(b)
            omega *= probs[b]
            env = Am[b] / torch.linalg.norm(Am[b])
        return tuple(config), omega

    @property
    def arrays_lrp(self):
        out = []
        for i in range(self._L):
            t = self[self.site_tag(i)]
            order = []
            if i > 0:
                order.extend(bonds(self[self.site_tag(i - 1)], t))
            if i < self._L - 1:
                order.extend(bonds(t, self[self.site_tag(i + 1)]))
            order.append(self.site_ind(i))
            out.append(t.transpose(*order).data)
        return out


def ar_multiply_axis(x, v, axis):
    shape = [1] * x.ndim
    shape[axis] = -1
    return x * v.to(x.dtype).reshape(shape)


def _swap_gate(d, dtype, device):
    """The (d^2, d^2) SWAP gate in ``dtype`` on ``device``."""
    SWAP = np.zeros((d, d, d, d))
    for a in range(d):
        for b in range(d):
            SWAP[b, a, a, b] = 1.0
    return to_device(SWAP.reshape(d * d, d * d), device=device, dtype=dtype)


def _fuse_pair_bonds(ts, cyc=False):
    """Fuse the doubled bonds between consecutive tensors of ``ts`` (and
    the wrap pair on a cyclic chain) into one bond each."""
    L = len(ts)
    for i in range(L if cyc else L - 1):
        t1, t2 = ts[i], ts[(i + 1) % L]
        shared = list(bonds(t1, t2))
        if len(shared) > 1:
            fused = rand_uuid()
            t1.fuse_({fused: shared})
            t2.fuse_({fused: shared})


def _ordered_site_arrays(ts, phys, cyc):
    """The data of the site tensors ``ts`` in 'lr' + ``phys(i)`` order."""
    L = len(ts)
    out = []
    for i, t in enumerate(ts):
        order = []
        if i > 0 or cyc:
            order.extend(bonds(ts[i - 1], t))
        if i < L - 1 or cyc:
            order.extend(bonds(t, ts[(i + 1) % L]))
        out.append(t.transpose(*order, *phys(i)).data)
    return out


# ---------------------------------------------------------------------------
# MPO
# ---------------------------------------------------------------------------


class MatrixProductOperator(TensorNetwork1DOperator, TensorNetwork1DFlat):
    """Matrix product operator (reference tn1d/core.py:3946). Default
    array layout 'lrud'."""

    _EXTRA_PROPS = ("_site_tag_id", "_upper_ind_id", "_lower_ind_id", "_L")

    def __init__(self, arrays, *, shape="lrud", tags=None,
                 upper_ind_id="k{}", lower_ind_id="b{}",
                 site_tag_id="I{}", cyclic=False, **tn_opts):
        if isinstance(arrays, MatrixProductOperator):
            super().__init__(arrays)
            return
        arrays = tuple(arrays)
        self._L = len(arrays)
        self._upper_ind_id = upper_ind_id
        self._lower_ind_id = lower_ind_id
        self._site_tag_id = site_tag_id
        tags = tags_to_oset(tags)

        nb = self._L if cyclic else self._L - 1
        bond_inds = [rand_uuid() for _ in range(nb)]
        tensors = []
        for i, arr in enumerate(arrays):
            inds = []
            for c in _lrp_order(shape, i, self._L, cyclic):
                if c == "l":
                    inds.append(bond_inds[i - 1])
                elif c == "r":
                    inds.append(bond_inds[i])
                elif c == "u":
                    inds.append(upper_ind_id.format(i))
                else:
                    inds.append(lower_ind_id.format(i))
            tensors.append(Tensor(
                arr, inds=inds, tags=tags | oset((site_tag_id.format(i),)),
            ))
        super().__init__(tensors, virtual=True, **tn_opts)

    def add_MPO(self, other, compress=False, **compress_opts):
        """``self + other`` by bond direct sum, open or cyclic."""
        arrays, cyc = _direct_sum_1d_arrays(
            self, other, lambda tn, i: (tn.upper_ind(i), tn.lower_ind(i)))
        new = MatrixProductOperator(
            arrays, shape="lrud", cyclic=cyc,
            upper_ind_id=self.upper_ind_id, lower_ind_id=self.lower_ind_id,
            site_tag_id=self.site_tag_id,
        )
        if compress:
            new.compress(**compress_opts)
        return new

    def __add__(self, other):
        return self.add_MPO(other)

    def __sub__(self, other):
        return self.add_MPO(other.multiply(-1))

    def apply(self, other, compress=False, **compress_opts):
        """This MPO applied to an MPS or an MPO, ``A|x>``: the exact zip,
        site by site, then optionally a compression."""
        if isinstance(other, MatrixProductState):
            return self._apply_mps(other, compress=compress,
                                   **compress_opts)
        if isinstance(other, MatrixProductOperator):
            return self._apply_mpo(other, compress=compress,
                                   **compress_opts)
        raise TypeError(f"cannot apply MPO to {type(other)}")

    dot = apply

    def _zip(self, other, A_id, B_id):
        """The site-by-site products of this MPO (its lower indices renamed
        ``A_id``) with ``other`` (``B_id`` renamed to the same), their
        doubled bonds fused; returns (tensors, cyclic)."""
        A, B = self.copy(), other.copy()
        # fresh bond names, so that applying an operator to itself does
        # not contract equal-named bonds
        A.mangle_inner_()
        B.mangle_inner_()
        tmp = "__mpo_apply{}__"
        A.reindex_lower_sites_(tmp)
        getattr(B, B_id)(tmp)
        L = self._L
        ts = [tensor_contract(A[A.site_tag(i)], B[B.site_tag(i)],
                              preserve_tensor=True) for i in range(L)]
        cyc = L > 2 and bool(bonds(ts[-1], ts[0]))
        _fuse_pair_bonds(ts, cyc)
        return ts, cyc

    def _apply_mps(self, psi, compress=False, **compress_opts):
        ts, cyc = self._zip(psi, "lower", "reindex_sites_")
        arrays = _ordered_site_arrays(
            ts, lambda i: (self.upper_ind(i),), cyc)
        new = MatrixProductState(
            arrays, shape="lrp", cyclic=cyc,
            site_ind_id=self._upper_ind_id, site_tag_id=psi._site_tag_id,
        )
        if compress and not cyc:
            new.compress(**compress_opts)
        return new

    def _apply_mpo(self, other, compress=False, **compress_opts):
        ts, cyc = self._zip(other, "lower", "reindex_upper_sites_")
        arrays = _ordered_site_arrays(
            ts, lambda i: (self.upper_ind(i), other.lower_ind(i)), cyc)
        new = MatrixProductOperator(
            arrays, shape="lrud", cyclic=cyc,
            upper_ind_id=self._upper_ind_id,
            lower_ind_id=other._lower_ind_id, site_tag_id=self._site_tag_id,
        )
        if compress and not cyc:
            new.compress(**compress_opts)
        return new

    def to_obc(self, compress=True, max_bond=None, cutoff=1e-12):
        """A cyclic MPO in exact open-boundary form: the wrap bond is
        carried through the chain (bond w * k), then optionally
        recompressed. Lets the open-chain engines run ring
        Hamiltonians."""
        if not self.cyclic:
            return self.copy()
        L = self._L
        ts = [self[self.site_tag(i)] for i in range(L)]
        wrap = next(iter(bonds(ts[L - 1], ts[0])))
        k = self.ind_size(wrap)
        arrays = []
        for i, t in enumerate(ts):
            u, lo = self.upper_ind(i), self.lower_ind(i)
            if i == 0:
                rb = next(iter(bonds(t, ts[1])))
                A = t.transpose(wrap, rb, u, lo).data  # (k, w, d, d)
                kk, w, d, _ = A.shape
                # the r space becomes (w, k): the wrap value goes right
                arrays.append(A.permute(1, 0, 2, 3).reshape(w * kk, d, d))
            elif i == L - 1:
                lb = next(iter(bonds(ts[i - 1], t)))
                A = t.transpose(lb, wrap, u, lo).data  # (w, k, d, d)
                w, kk, d, _ = A.shape
                arrays.append(A.reshape(w * kk, d, d))
            else:
                lb = next(iter(bonds(ts[i - 1], t)))
                rb = next(iter(bonds(t, ts[i + 1])))
                A = t.transpose(lb, rb, u, lo).data  # (wl, wr, d, d)
                wl, wr, d, _ = A.shape
                eye = torch.eye(k, dtype=A.dtype, device=A.device)
                # (wl, k), (wr, k), d, d: the wrap value carried unchanged
                arr = torch.einsum("abud,ck->acbkud", A, eye)
                arrays.append(arr.reshape(wl * k, wr * k, d, d))
        new = MatrixProductOperator(
            arrays, shape="lrud", upper_ind_id=self.upper_ind_id,
            lower_ind_id=self.lower_ind_id, site_tag_id=self.site_tag_id,
        )
        if compress:
            new.compress(max_bond=max_bond, cutoff=cutoff)
        return new

    def trace(self, **contract_opts):
        """Trace of the full operator."""
        tn = self.reindex({self.lower_ind(i): self.upper_ind(i)
                           for i in range(self._L)})
        return tn.contract(..., **contract_opts)

    def partial_transpose(self, sysa, inplace=False):
        """Partial transpose over sites ``sysa``."""
        tn = self if inplace else self.copy()
        remap = {}
        for i in sysa:
            remap[tn.upper_ind(i)] = tn.lower_ind(i)
            remap[tn.lower_ind(i)] = tn.upper_ind(i)
        return tn.reindex_(remap)

    @property
    def H(self):
        """Hermitian conjugate: conjugate data, swap upper and lower."""
        A = self.conj()
        remap = {}
        for i in range(self._L):
            remap[A.upper_ind(i)] = A.lower_ind(i)
            remap[A.lower_ind(i)] = A.upper_ind(i)
        return A.reindex_(remap)

    def rand_state(self, bond_dim, dtype=None, **kwargs):
        """A random MPS with this MPO's physical indices, on its device."""
        from .builders import MPS_rand_state

        kwargs.setdefault("device", _tn_device(self))
        return MPS_rand_state(
            self._L, bond_dim, phys_dim=self.phys_dim(),
            dtype=dtype or self.dtype, site_ind_id=self._upper_ind_id,
            site_tag_id=self._site_tag_id, **kwargs,
        )

    def identity(self, **kwargs):
        from .builders import MPO_identity_like

        return MPO_identity_like(self, **kwargs)


# ---------------------------------------------------------------------------
# Dense1D and functions
# ---------------------------------------------------------------------------


class Dense1D(TensorNetwork1DVector):
    """A dense state as a one-tensor 1D network (reference
    tn1d/core.py:4467), on ``device``."""

    _EXTRA_PROPS = ("_site_tag_id", "_site_ind_id", "_L")

    def __init__(self, array, phys_dim=2, tags=None, site_ind_id="k{}",
                 site_tag_id="I{}", device=None, **tn_opts):
        array = to_device(array, device=resolve_device(device))
        L = int(round(math.log(array.numel(), phys_dim)))
        self._L = L
        self._site_ind_id = site_ind_id
        self._site_tag_id = site_tag_id
        t = Tensor(
            array.reshape((phys_dim,) * L),
            inds=[site_ind_id.format(i) for i in range(L)],
            tags=tags_to_oset(tags) | oset(site_tag_id.format(i)
                                           for i in range(L)),
        )
        TensorNetwork.__init__(self, (t,), virtual=True, **tn_opts)

    @classmethod
    def rand(cls, n, phys_dim=2, dtype="float64", seed=None, device=None,
             **kwargs):
        """A random normalised dense state on ``n`` sites."""
        from ...gen.rand import randn

        device = resolve_device(device)
        array = randn((phys_dim,) * n, dtype=dtype, seed=seed, device=device)
        array = array / torch.linalg.norm(array.reshape(-1))
        return cls(array, phys_dim=phys_dim, device=device, **kwargs)


def gate_TN_1D(tn, G, where, contract=False, tags=None, inplace=False,
               **compress_opts):
    """Apply a gate to one or more sites of a 1D vector network
    (reference ``gate_TN_1D`` tn1d/core.py:98)."""
    from ..gating import tensor_network_gate_inds

    if isinstance(where, (int, np.integer)):
        where = (int(where),)
    inds = tuple(tn.site_ind(i) for i in where)
    return tensor_network_gate_inds(
        tn, G, inds, contract=contract, tags=tags, inplace=inplace,
        **compress_opts,
    )


def _absorb_greedily(env, ts, optimize=None):
    """Contract the tensors ``ts`` into ``env`` (``None`` to start from
    the smallest), pairwise, each step with the tensor that shares an
    index with the environment and gives the smallest result."""
    ts = list(ts)
    while ts:
        if env is None:
            env = min(ts, key=lambda t: t.size)
            ts.remove(env)
            continue
        shared = {id(t): set(bonds(env, t)) for t in ts}
        linked = [t for t in ts if shared[id(t)]] or ts

        def out_size(t):
            return math.prod(
                ix_size for ixs, x in ((env.inds, env), (t.inds, t))
                for ix in ixs if ix not in shared[id(t)]
                for ix_size in (x.ind_size(ix),))

        t = min(linked, key=out_size)
        ts.remove(t)
        env = tensor_contract(env, t, preserve_tensor=True,
                              optimize=optimize)
    return env


def expec_TN_1D(*tns, compress=None, eff=False, optimize=None):
    """The value of a 1D sandwich of networks such as ``(bra, op, ket)``,
    contracted from the left (reference ``expec_TN_1D``
    tn1d/core.py:55).

    An environment tensor absorbs the tensors of each site one at a time,
    each step a pairwise product with the site's tensor that shares an
    index with it and gives the smallest result. So no intermediate is
    larger than the environment times one site tensor; quimb_tpu merges a
    site's column before the chain, an outer product over the bonds."""
    tn = functools.reduce(lambda a, b: a & b, tns)
    first = next(t for t in tns if hasattr(t, "_L"))
    L = max(t._L for t in tns if hasattr(t, "_L"))
    done = set()
    env = None
    for i in range(L):
        ts = [t for t in tn.select_tensors(first.site_tag(i), which="any")
              if id(t) not in done]
        done.update(map(id, ts))
        env = _absorb_greedily(env, ts, optimize)
    rest = [t for t in tn.tensor_map.values() if id(t) not in done]
    env = _absorb_greedily(env, rest, optimize)
    out = env.data
    if env.inds:
        # remaining open indices (an operator's size-1 ends) sum out
        out = out.sum()
    return out * 10 ** tn.exponent if tn.exponent else out.reshape(())


def align_TN_1D(*tns, ind_ids=None, inplace=False):
    """Align a sandwich of 1D networks such as ``(bra, op, ket)`` so that
    their physical indices chain (reference ``align_TN_1D``): the first
    network keeps its indices, an operator's upper indices take those of
    the network before it and its lower ones the ids ``ind_ids[i]``
    (fresh by default), and the last vector takes the ids before it.

    quimb_tpu renames an operator's lower indices to the previous
    network's ids before its upper ones; with the default ids ``k{}``
    both on the bra and the upper side, the operator's two physical
    indices then share one name (ROADMAP §3)."""
    tns = [tn if inplace else tn.copy() for tn in tns]
    n = len(tns)
    if ind_ids is None:
        first = tns[0]
        ind_ids = [first._site_ind_id
                   if isinstance(first, TensorNetwork1DVector)
                   else first._lower_ind_id]
        ind_ids.extend(rand_uuid() + "{}" for _ in range(n - 2))
    for i, tn in enumerate(tns):
        if isinstance(tn, TensorNetwork1DOperator):
            up = tn._upper_ind_id if i == 0 else ind_ids[i - 1]
            lo = ind_ids[i] if i < n - 1 else tn._lower_ind_id
            # both renamings at once: the old and new ids may overlap
            remap = {}
            for s in range(tn._L):
                remap[tn.upper_ind(s)] = up.format(s)
                remap[tn.lower_ind(s)] = lo.format(s)
            tn.reindex_(remap)
            tn._upper_ind_id, tn._lower_ind_id = up, lo
        elif isinstance(tn, TensorNetwork1DVector) and i > 0:
            tn.reindex_sites_(ind_ids[i - 1])
    return tns


class SuperOperator1D(TensorNetwork1D):
    """A 1D superoperator network with four physical indices a site:
    outer and inner kets and bras (reference ``SuperOperator1D``
    tn1d/core.py:4538)."""

    _EXTRA_PROPS = (
        "_site_tag_id", "_L",
        "_outer_upper_ind_id", "_inner_upper_ind_id",
        "_outer_lower_ind_id", "_inner_lower_ind_id",
    )

    @property
    def outer_upper_ind_id(self):
        return self._outer_upper_ind_id

    @property
    def inner_upper_ind_id(self):
        return self._inner_upper_ind_id

    @property
    def outer_lower_ind_id(self):
        return self._outer_lower_ind_id

    @property
    def inner_lower_ind_id(self):
        return self._inner_lower_ind_id

    def __init__(self, arrays, *, shape="lrkudb",
                 outer_upper_ind_id="kn{}", inner_upper_ind_id="k{}",
                 outer_lower_ind_id="bn{}", inner_lower_ind_id="b{}",
                 site_tag_id="I{}", tags=None, **tn_opts):
        if isinstance(arrays, SuperOperator1D):
            super().__init__(arrays)
            return
        arrays = tuple(arrays)
        self._L = len(arrays)
        self._site_tag_id = site_tag_id
        self._outer_upper_ind_id = outer_upper_ind_id
        self._inner_upper_ind_id = inner_upper_ind_id
        self._outer_lower_ind_id = outer_lower_ind_id
        self._inner_lower_ind_id = inner_lower_ind_id
        tags = tags_to_oset(tags)
        ids = {"k": outer_upper_ind_id, "u": inner_upper_ind_id,
               "d": inner_lower_ind_id, "b": outer_lower_ind_id}
        bond_inds = [rand_uuid() for _ in range(self._L - 1)]
        tensors = []
        for i, arr in enumerate(arrays):
            inds = []
            for c in _lrp_order(shape, i, self._L, False):
                if c == "l":
                    inds.append(bond_inds[i - 1])
                elif c == "r":
                    inds.append(bond_inds[i])
                elif c in ids:
                    inds.append(ids[c].format(i))
                else:
                    raise ValueError(f"unknown shape char {c}")
            tensors.append(Tensor(
                arr, inds=inds, tags=tags | oset((site_tag_id.format(i),)),
            ))
        TensorNetwork.__init__(self, tensors, virtual=True, **tn_opts)

    @classmethod
    def rand(cls, L, bond_dim, phys_dim=2, dtype=None, seed=None,
             device=None, **kwargs):
        from ...gen.rand import randn

        arrays = []
        for i in range(L):
            shape = []
            if i > 0:
                shape.append(bond_dim)
            if i < L - 1:
                shape.append(bond_dim)
            shape.extend([phys_dim] * 4)
            arrays.append(randn(
                tuple(shape), dtype=dtype,
                seed=None if seed is None else seed + i, device=device,
            ))
        return cls(arrays, **kwargs)


def TNLinearOperator1D(tn, left_inds, right_inds, start=None, stop=None,
                       **kwargs):
    """A 1D network section as a linear operator (reference
    ``TNLinearOperator1D`` tn1d/core.py:4756)."""
    raise _deferred(16, "TNLinearOperator1D (linop.py)")


def superop_TN_1D(tn_super, tn_op, upper_ind_id="k{}",
                  lower_ind_id="b{}", so_outer_upper_ind_id=None,
                  so_inner_upper_ind_id=None,
                  so_inner_lower_ind_id=None,
                  so_outer_lower_ind_id=None):
    """Act with a 1D superoperator network on a 1D operator network,
    keeping the operator's outer index ids (reference ``superop_TN_1D``
    tn1d/core.py:266)."""
    n = tn_op.L
    so_outer_upper_ind_id = so_outer_upper_ind_id or getattr(
        tn_super, "outer_upper_ind_id", "kn{}")
    so_inner_upper_ind_id = so_inner_upper_ind_id or getattr(
        tn_super, "inner_upper_ind_id", "k{}")
    so_inner_lower_ind_id = so_inner_lower_ind_id or getattr(
        tn_super, "inner_lower_ind_id", "b{}")
    so_outer_lower_ind_id = so_outer_lower_ind_id or getattr(
        tn_super, "outer_lower_ind_id", "bn{}")
    reindex_map = {}
    for i in range(n):
        upper_bnd, lower_bnd = rand_uuid(), rand_uuid()
        reindex_map[upper_ind_id.format(i)] = upper_bnd
        reindex_map[lower_ind_id.format(i)] = lower_bnd
        reindex_map[so_inner_upper_ind_id.format(i)] = upper_bnd
        reindex_map[so_inner_lower_ind_id.format(i)] = lower_bnd
        reindex_map[so_outer_upper_ind_id.format(i)] = \
            upper_ind_id.format(i)
        reindex_map[so_outer_lower_ind_id.format(i)] = \
            lower_ind_id.format(i)
    return TensorNetwork((tn_super.reindex(reindex_map),
                          tn_op.reindex(reindex_map)))


# ---------------------------------------------------------------------------
# uniform array forms (the layout of the DMRG, TEBD and parallel sweeps)
# ---------------------------------------------------------------------------


def _mps_uniform_arrays(psi):
    """An open MPS's site arrays as uniform ``(l, p, r)`` tensors, the
    chain's ends padded with size-1 bonds."""
    L = psi.L
    out = []
    for i in range(L):
        t = psi[psi.site_tag(i)]
        lshared = list(bonds(psi[psi.site_tag(i - 1)], t)) if i > 0 else []
        rshared = (list(bonds(t, psi[psi.site_tag(i + 1)]))
                   if i < L - 1 else [])
        arr = t.transpose(*lshared, psi.site_ind(i), *rshared).data
        if not lshared:
            arr = arr[None, ...]
        if not rshared:
            arr = arr[..., None]
        out.append(arr)
    return out


def _mpo_uniform_arrays(ham):
    """An open MPO's site arrays as uniform ``(wl, wr, u, d)`` tensors,
    the chain's ends padded with size-1 bonds."""
    L = ham.L
    out = []
    for i in range(L):
        t = ham[ham.site_tag(i)]
        lshared = list(bonds(ham[ham.site_tag(i - 1)], t)) if i > 0 else []
        rshared = (list(bonds(t, ham[ham.site_tag(i + 1)]))
                   if i < L - 1 else [])
        arr = t.transpose(*lshared, *rshared, ham.upper_ind(i),
                          ham.lower_ind(i)).data
        if not lshared:
            arr = arr[None, ...]
        if not rshared:
            arr = arr[:, None, ...]
        out.append(arr)
    return out


def _arrays_to_mps(arrays, like=None, **mps_opts):
    """Uniform ``(l, p, r)`` tensors -> an open :class:`MatrixProductState`
    (with the index and tag ids of ``like`` when given)."""
    if like is not None:
        mps_opts.update(site_ind_id=like._site_ind_id,
                        site_tag_id=like._site_tag_id)
    L = len(arrays)
    site_arrays = []
    for i, a in enumerate(arrays):
        if L == 1:
            a = a[0, :, 0]
        elif i == 0:
            a = a[0].transpose(0, 1)
        elif i == L - 1:
            a = a[..., 0]
        else:
            a = a.permute(0, 2, 1)
        site_arrays.append(a)
    return MatrixProductState(site_arrays, shape="lrp", **mps_opts)


def _arrays_to_mpo(arrays, upper_ind_id="k{}", lower_ind_id="b{}",
                   site_tag_id="I{}"):
    """Uniform ``(wl, wr, u, d)`` tensors -> an open
    :class:`MatrixProductOperator`."""
    L = len(arrays)
    site_arrays = []
    for i, a in enumerate(arrays):
        if L == 1:
            a = a[0, 0]
        elif i == 0:
            a = a[0]
        elif i == L - 1:
            a = a[:, 0]
        site_arrays.append(a)
    return MatrixProductOperator(site_arrays, shape="lrud",
                                 upper_ind_id=upper_ind_id,
                                 lower_ind_id=lower_ind_id,
                                 site_tag_id=site_tag_id)


# ---------------------------------------------------------------------------
# the rest of the methods of the 1D classes (reference tn1d/core.py)
# ---------------------------------------------------------------------------


def _flat_show(self, max_width=None):
    """Ascii bond-dimension diagram (reference ``show``)."""
    line = "".join(f"●─{d}─" for d in self.bond_sizes()) + "●"
    print(line)
    return line


def _flat_count_canonized(self):
    """Number of (left, right) canonized sites from each end."""
    nl = 0
    while nl < self.L - 1 and self._site_is_left_canonical(nl):
        nl += 1
    nr = 0
    while nr < self.L - 1 - nl and self._site_is_right_canonical(
            self.L - 1 - nr):
        nr += 1
    return nl, nr


def _flat_singular_values(self, i, cur_orthog="calc", method="svd"):
    return self.schmidt_values(i, cur_orthog=cur_orthog,
                               method=method) ** 0.5


def _flat_left_compress_site(self, i, bra=None, **split_opts):
    """Truncating left-canonization of one site."""
    tensor_compress_bond(self[self.site_tag(i)], self[self.site_tag(i + 1)],
                         absorb="right", **split_opts)
    if bra is not None:
        self._sync_bra(bra, i, i + 1)


def _flat_right_compress_site(self, i, bra=None, **split_opts):
    tensor_compress_bond(self[self.site_tag(i)], self[self.site_tag(i - 1)],
                         absorb="right", **split_opts)
    if bra is not None:
        self._sync_bra(bra, i, i - 1)


def _flat_left_compress(self, start=None, stop=None, bra=None,
                        **split_opts):
    """Truncating left-canonization sweep."""
    start = 0 if start is None else start
    stop = self.L - 1 if stop is None else stop
    for i in range(start, stop):
        _flat_left_compress_site(self, i, bra=bra, **split_opts)
    return self


def _flat_right_compress(self, start=None, stop=None, bra=None,
                         **split_opts):
    start = self.L - 1 if start is None else start
    stop = 0 if stop is None else stop
    for i in range(start, stop, -1):
        _flat_right_compress_site(self, i, bra=bra, **split_opts)
    return self


def _flat_ensure_bonds_exist(self):
    """Add size-1 bonds between any unbonded neighbours."""
    from ..core import new_bond

    for i in range(self.L - 1):
        t1, t2 = self[self.site_tag(i)], self[self.site_tag(i + 1)]
        if not bonds(t1, t2):
            new_bond(t1, t2, size=1)
    return self


def _flat_as_cyclic(self, inplace=False):
    """Add a size-1 wrap bond, making the network formally cyclic."""
    from ..core import new_bond

    tn = self if inplace else self.copy()
    t1, t2 = tn[tn.site_tag(0)], tn[tn.site_tag(tn.L - 1)]
    if not bonds(t1, t2):
        new_bond(t1, t2, size=1)
    return tn


TensorNetwork1DFlat.show = _flat_show
TensorNetwork1DFlat.count_canonized = _flat_count_canonized
TensorNetwork1DFlat.singular_values = _flat_singular_values
TensorNetwork1DFlat.left_compress_site = _flat_left_compress_site
TensorNetwork1DFlat.right_compress_site = _flat_right_compress_site
TensorNetwork1DFlat.left_compress = _flat_left_compress
TensorNetwork1DFlat.right_compress = _flat_right_compress
TensorNetwork1DFlat.ensure_bonds_exist = _flat_ensure_bonds_exist
TensorNetwork1DFlat.as_cyclic = _flat_as_cyclic
# the reference renamed canonize -> canonicalize
TensorNetwork1DFlat.left_canonicalize = TensorNetwork1DFlat.left_canonize
TensorNetwork1DFlat.left_canonicalize_ = TensorNetwork1DFlat.left_canonize
TensorNetwork1DFlat.right_canonicalize = TensorNetwork1DFlat.right_canonize
TensorNetwork1DFlat.right_canonicalize_ = TensorNetwork1DFlat.right_canonize
TensorNetwork1DFlat.canonicalize = TensorNetwork1DFlat.canonize
TensorNetwork1DFlat.canonicalize_ = TensorNetwork1DFlat.canonize


# -- MatrixProductState ------------------------------------------------------

def _fill_fn_shapes(L, bond_dim, phys, cyclic):
    for i in range(L):
        shp = []
        if i > 0 or cyclic:
            shp.append(bond_dim)
        if i < L - 1 or cyclic:
            shp.append(bond_dim)
        yield tuple(shp) + phys


@classmethod
def _mps_from_fill_fn(cls, fill_fn, L, bond_dim, phys_dim=2,
                      cyclic=False, shape="lrp", **mps_opts):
    """An MPS with arrays ``fill_fn(shape)`` (reference
    ``MPS.from_fill_fn``)."""
    arrays = [fill_fn(s) for s in _fill_fn_shapes(L, bond_dim, (phys_dim,),
                                                 cyclic)]
    return cls(arrays, shape="lrp", cyclic=cyclic, **mps_opts)


def _replace_tensors(self, out):
    for t_self, t_new in zip(self.tensor_map.values(),
                             out.tensor_map.values()):
        t_self.modify(data=t_new.data, inds=t_new.inds)
    return self


def _mps_add_MPS_(self, other, **kwargs):
    return _replace_tensors(self, self.add_MPS(other, **kwargs))


def _mps_gate_with_mpo(self, mpo, max_bond=None, cutoff=1e-10,
                       method="dm", inplace=False, **kwargs):
    """Apply an MPO with a bounded bond (reference ``gate_with_mpo``), by
    the 1D compression methods of :mod:`.compress`."""
    from .compress import mps_gate_with_mpo

    out = mps_gate_with_mpo(self, mpo, max_bond=max_bond, cutoff=cutoff,
                            method=method, **kwargs)
    if inplace and out.num_tensors == self.num_tensors:
        return _replace_tensors(self, out)
    return out


def _mps_permute_arrays(self, shape="lrp"):
    """The arrays are stored by index name: their layout is already
    canonical (reference ``permute_arrays``)."""
    return self


def _mps_swap_site_to(self, i, f, cur_orthog=None, inplace=False,
                      **compress_opts):
    """Move the physical site ``i`` to position ``f`` by neighbour SWAP
    gates (reference ``swap_site_to``)."""
    psi = self if inplace else self.copy()
    SWAP = _swap_gate(psi.phys_dim(), psi.dtype, _tn_device(psi))
    step = 1 if f > i else -1
    j = i
    while j != f:
        psi.gate_split_(SWAP, (j, j + 1) if step == 1 else (j - 1, j),
                        **compress_opts)
        j += step
    return psi


def _mps_swap_sites_with_compress(self, i, j, cur_orthog=None,
                                  inplace=False, **compress_opts):
    """Exchange the contents of two sites, with compression."""
    psi = self if inplace else self.copy()
    if i == j:
        return psi
    i, j = sorted((i, j))
    _mps_swap_site_to(psi, i, j, inplace=True, **compress_opts)
    _mps_swap_site_to(psi, j - 1, i, inplace=True, **compress_opts)
    return psi


def _mps_bipartite_schmidt_state(self, sz_a, get="ket", cur_orthog=None):
    """The state as a dense (D_a, D_b) form across the cut after ``sz_a``
    sites (reference ``bipartite_schmidt_state``)."""
    psi = self.copy()
    psi.canonize(max(sz_a - 1, 0))
    TL = tensor_contract(*(psi[psi.site_tag(i)] for i in range(sz_a)),
                         preserve_tensor=True)
    TR = tensor_contract(*(psi[psi.site_tag(i)]
                           for i in range(sz_a, psi.L)),
                         preserve_tensor=True)
    (bix,) = bonds(TL, TR)
    lked = [ix for ix in TL.inds if ix != bix]
    rked = [ix for ix in TR.inds if ix != bix]
    ml = TL.transpose(*lked, bix).data.reshape(-1, TL.ind_size(bix))
    mr = TR.transpose(bix, *rked).data.reshape(TR.ind_size(bix), -1)
    full = ml @ mr
    if get in ("ket", "psi"):
        return full.reshape(-1, 1)
    if get == "rho":
        v = full.reshape(-1)
        return torch.outer(v, v.conj())
    return full


def _mps_logneg_subsys(self, sysa, sysb, compress_opts=None,
                       approx_thresh=None, **kwargs):
    raise _deferred(16, "MatrixProductState.logneg_subsys (calc.py)")


def _mps_partial_trace_to_dense_canonical(self, keep, **contract_opts):
    """Dense reduced density matrix of ``keep``."""
    return self.partial_trace(keep)


def _mps_lazy_rho_tn(self, keep, upper_ind_id="b{}"):
    """The two-layer reduced-density network, unconstracted."""
    bra = self.H
    bra.reindex_({self.site_ind(i): upper_ind_id.format(i) for i in keep})
    return TensorNetwork((self.copy(), bra), virtual=True)


def _mps_partial_trace_to_mpo(self, keep, upper_ind_id="k{}",
                              lower_ind_id="b{}", **compress_opts):
    """The reduced density operator of ``keep`` as an operator chain
    (reference ``partial_trace_to_mpo``)."""
    keep = sorted(keep)
    tn = _mps_lazy_rho_tn(self, keep, upper_ind_id="__pt{}__")
    for i in (i for i in range(self.L) if i not in keep):
        # absorb a traced column into the nearest kept column
        tgt = min(keep, key=lambda k: abs(k - i))
        tn.contract_tags_((self.site_tag(i), self.site_tag(tgt)),
                          which="any")
    for tag in (self.site_tag(i) for i in keep):
        if len(tn.tag_map.get(tag, ())) > 1:
            tn.contract_tags_(tag, which="any")
    tn.fuse_multibonds_()
    tn.reindex_({f"__pt{i}__": lower_ind_id.format(n)
                 for n, i in enumerate(keep)})
    tn.reindex_({self.site_ind(i): upper_ind_id.format(n)
                 for n, i in enumerate(keep)})
    tn.retag_({self.site_tag(i): f"I{n}" for n, i in enumerate(keep)})
    tn.view_as_(TensorNetwork1DOperator, L=len(keep), site_tag_id="I{}",
                upper_ind_id=upper_ind_id, lower_ind_id=lower_ind_id)
    if compress_opts.get("max_bond") is not None:
        for n in range(len(keep) - 1):
            if bonds(tn[f"I{n}"], tn[f"I{n + 1}"]):
                tn.compress_between(f"I{n}", f"I{n + 1}", **compress_opts)
    return tn


def _mps_sample_configuration(self, seed=None, info=None):
    """One configuration and its probability."""
    psi = self.copy()
    psi.canonize(0)
    return self._sample_one(psi, np.random.default_rng(seed))


def _mps_expec_gate(self, G, where):
    psik = self.gate(G, where, contract="reduce-split" if len(where) == 2
                     else True)
    return self.H @ psik


def _mps_local_expectation_canonical(self, G, where, **kwargs):
    return _mps_expec_gate(self, G, where) / (self.H @ self)


def _mps_compute_local_expectation(self, terms, **kwargs):
    """The sum of ``<psi|G|psi>`` over the ``{where: G}`` terms."""
    total = 0.0
    for where, G in terms.items():
        if isinstance(where, (int, np.integer)):
            where = (int(where),)
        total += complex(_mps_expec_gate(self, G, where))
    return total.real if abs(total.imag) < 1e-10 else total


MatrixProductState.from_fill_fn = _mps_from_fill_fn
MatrixProductState.add_MPS_ = _mps_add_MPS_
MatrixProductState.gate_with_mpo = _mps_gate_with_mpo
MatrixProductState.gate_with_mpo_ = functools.partialmethod(
    _mps_gate_with_mpo, inplace=True)
MatrixProductState.permute_arrays = _mps_permute_arrays
MatrixProductState.bipartite_schmidt_state = _mps_bipartite_schmidt_state
MatrixProductState.partial_trace_to_dense_canonical = \
    _mps_partial_trace_to_dense_canonical
MatrixProductState.partial_trace_to_mpo = _mps_partial_trace_to_mpo
MatrixProductState.partial_trace_compress = _mps_partial_trace_to_mpo
MatrixProductState.logneg_subsys = _mps_logneg_subsys
MatrixProductState.sample_configuration = _mps_sample_configuration
MatrixProductState.expec_gate = _mps_expec_gate
MatrixProductState.local_expectation_canonical = \
    _mps_local_expectation_canonical
MatrixProductState.compute_local_expectation = \
    _mps_compute_local_expectation
MatrixProductState.compute_local_expectation_canonical = \
    _mps_compute_local_expectation
MatrixProductState.compute_local_expectation_via_envs = \
    _mps_compute_local_expectation
MatrixProductState.swap_site_to = _mps_swap_site_to
MatrixProductState.swap_site_to_ = functools.partialmethod(
    _mps_swap_site_to, inplace=True)
MatrixProductState.swap_sites_with_compress = _mps_swap_sites_with_compress
MatrixProductState.swap_sites_with_compress_ = functools.partialmethod(
    _mps_swap_sites_with_compress, inplace=True)
MatrixProductState.gate_nonlocal = MatrixProductState.gate_with_auto_swap
MatrixProductState.gate_nonlocal_ = functools.partialmethod(
    MatrixProductState.gate_with_auto_swap, inplace=True)


# -- MatrixProductOperator ----------------------------------------------------

@classmethod
def _mpo_from_fill_fn(cls, fill_fn, L, bond_dim, phys_dim=2,
                      cyclic=False, **mpo_opts):
    """An MPO with arrays ``fill_fn(shape)``."""
    arrays = [fill_fn(s) for s in _fill_fn_shapes(
        L, bond_dim, (phys_dim, phys_dim), cyclic)]
    return cls(arrays, shape="lrud", cyclic=cyclic, **mpo_opts)


def _mpo_compact_from_dense(A, dims, split_opts):
    """The site arrays ('lrud') of the dense operator ``A`` on ``len(dims)``
    consecutive sites, by successive SVDs."""
    L = len(dims)
    t = A.reshape(*dims, *dims)
    perm = [ax for i in range(L) for ax in (i, L + i)]
    carry = t.permute(*perm).reshape(1, -1)
    arrays = []
    for i in range(L):
        d = dims[i]
        l = carry.shape[0]
        mat = carry.reshape(l * d * d, -1)
        if i < L - 1:
            U, _, sVH = decomp.array_split(mat, method="svd",
                                           absorb="right", **split_opts)
            a = U.reshape(l, d, d, U.shape[-1])
            carry = sVH
            # (l, u, d, r) -> 'lrud'; the first site has no l
            a = a[0].permute(2, 0, 1) if i == 0 else a.permute(0, 3, 1, 2)
        else:
            # the last site has no r; a single site has no l either
            # (quimb_tpu reshapes it to (1, d, d) and fails on it)
            a = mat.reshape(d, d) if L == 1 else mat.reshape(l, d, d)
        arrays.append(a)
    return arrays


@classmethod
def _mpo_from_dense(cls, A, dims=2, sites=None, L=None, upper_ind_id="k{}",
                    lower_ind_id="b{}", site_tag_id="I{}", device=None,
                    **split_opts):
    """An MPO of the dense operator ``A`` by successive SVDs (reference
    ``MPO.from_dense``), on ``device``. With ``sites`` / ``L`` the
    operator acts on those (possibly non-adjacent) sites of an ``L``-site
    chain: identity tensors carry the bonds in between, and the sites
    outside get identities."""
    A = to_device(A, device=resolve_device(device))
    D = A.shape[0]
    ids = dict(upper_ind_id=upper_ind_id, lower_ind_id=lower_ind_id,
               site_tag_id=site_tag_id)
    split_opts.setdefault("cutoff", 1e-12)
    if sites is None:
        if isinstance(dims, int):
            dims = (dims,) * int(round(math.log(D) / math.log(dims)))
        return cls(_mpo_compact_from_dense(A, tuple(dims), split_opts),
                   shape="lrud", **ids)
    sites = sorted(sites)
    L = max(sites) + 1 if L is None else L
    d = dims if isinstance(dims, int) else dims[0]
    n = int(round(math.log(D) / math.log(d)))
    compact = cls(_mpo_compact_from_dense(A, (d,) * n, split_opts),
                  shape="lrud", **ids)
    # re-site the compact MPO onto the sparse positions, threading each
    # interior bond through identity tensors
    tensors = []
    for j, site in enumerate(sites):
        t = compact[compact.site_tag(j)].copy()
        t.reindex_({compact.upper_ind(j): upper_ind_id.format(site),
                    compact.lower_ind(j): lower_ind_id.format(site)})
        t.retag_({compact.site_tag(j): site_tag_id.format(site)})
        tensors.append((site, t))
    tn = TensorNetwork([t for _, t in tensors])
    eye_d = torch.eye(d, dtype=A.dtype, device=A.device)
    for (sa, ta), (sb, tb) in zip(tensors, tensors[1:]):
        (bix,) = [ix for ix in ta.inds if ix in tb.inds]
        Db = ta.ind_size(bix)
        eye_b = torch.eye(Db, dtype=A.dtype, device=A.device)
        ident = torch.einsum("ab,ud->abud", eye_b, eye_d)
        prev = bix
        for s in range(sa + 1, sb):
            nb = rand_uuid()
            tn.add_tensor(Tensor(
                ident, inds=(prev, nb, upper_ind_id.format(s),
                             lower_ind_id.format(s)),
                tags=(site_tag_id.format(s),)))
            prev = nb
        if prev != bix:
            tb.reindex_({bix: prev})
    for s in range(L):
        if site_tag_id.format(s) not in tn.tag_map:
            tn.add_tensor(Tensor(
                eye_d, inds=(upper_ind_id.format(s), lower_ind_id.format(s)),
                tags=(site_tag_id.format(s),)))
    tn.view_as_(cls, L=L, **ids)
    return tn


def _mpo_add_MPO_(self, other, **kwargs):
    return _replace_tensors(self, self.add_MPO(other, **kwargs))


def _mpo_fill_empty_sites(self, mode="full", phys_dim=None,
                          fill_array=None, inplace=False):
    """Identity tensors on any sites this MPO lacks."""
    tn = self if inplace else self.copy()
    d = phys_dim or tn.phys_dim()
    device = _tn_device(tn)
    for i in range(tn.L):
        if tn.site_tag(i) not in tn.tag_map:
            arr = (to_device(fill_array, device=device)
                   if fill_array is not None else
                   torch.eye(d, dtype=tn.dtype, device=device))
            tn.add_tensor(Tensor(arr, inds=(tn.upper_ind(i),
                                            tn.lower_ind(i)),
                                 tags=(tn.site_tag(i),)), virtual=True)
    return tn


MatrixProductOperator.from_fill_fn = _mpo_from_fill_fn
MatrixProductOperator.from_dense = _mpo_from_dense
MatrixProductOperator.add_MPO_ = _mpo_add_MPO_
MatrixProductOperator.fill_empty_sites = _mpo_fill_empty_sites
MatrixProductOperator.fill_empty_sites_ = functools.partialmethod(
    _mpo_fill_empty_sites, inplace=True)
MatrixProductOperator.permute_arrays = _mps_permute_arrays


# -- TensorNetwork1D ----------------------------------------------------------

def _1d_has_site(self, site):
    return 0 <= site < self._L


def _1d_flatten(self, fuse_multibonds=True, inplace=False):
    """Contract the tensors of each site into one (reference ``flatten``
    tn1d/core.py:609)."""
    tn = self if inplace else self.copy()
    for i in range(tn._L):
        tag = tn.site_tag(i)
        if len(tn.tag_map.get(tag, ())) > 1:
            tn.contract_tags_(tag, which="any")
    if fuse_multibonds:
        tn.fuse_multibonds_()
    return tn


def _1d_environments(self, sites, **contract_opts):
    """``envs[j]``: the contraction of the sites before ``j`` in
    ``sites``' order, for each ``j`` after the first two."""
    envs = {}
    env = None
    for prev, j in zip(sites, sites[1:]):
        tn = self.select(self.site_tag(prev))
        if env is not None:
            tl = env.copy()
            tl.drop_tags()
            tn = tn | tl
        env = envs[j] = tn.contract(..., preserve_tensor=True,
                                    **contract_opts)
    return envs


def _1d_compute_left_environments(self, **contract_opts):
    """``envs[i]``: everything strictly left of site ``i``, contracted
    (reference ``compute_left_environments`` tn1d/core.py:559)."""
    return _1d_environments(self, list(range(self._L)), **contract_opts)


def _1d_compute_right_environments(self, **contract_opts):
    """``envs[i]``: everything strictly right of site ``i``, contracted
    (reference ``compute_right_environments`` tn1d/core.py:583)."""
    return _1d_environments(self, list(range(self._L - 1, -1, -1)),
                            **contract_opts)


TensorNetwork1D.has_site = _1d_has_site
TensorNetwork1D.flatten = _1d_flatten
TensorNetwork1D.flatten_ = functools.partialmethod(_1d_flatten, inplace=True)
TensorNetwork1D.compute_left_environments = _1d_compute_left_environments
TensorNetwork1D.compute_right_environments = _1d_compute_right_environments
