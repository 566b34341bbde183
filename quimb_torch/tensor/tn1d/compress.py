"""1D tensor network compression: the methods the MPS layer calls.

Port of part of quimb_tpu's ``tensor/tn1d/compress.py`` (reference
``quimb/tensor/tn1d/compress.py``: ``tensor_network_1d_compress`` :2815,
direct :138, density-matrix :382, zip-up :667 and its oversampled form
:910, ``mps_gate_with_mpo_*`` :2956-3215, ``enforce_1d_like`` :37): the
methods ``direct``, ``dm``, ``zipup`` and ``zipup-oversample``, which
``MatrixProductState.gate_with_mpo`` and ``CircuitMPSLazy`` use. The
methods ``fit``, ``src``, ``src-oversample``, ``projector`` and ``bidm``
raise, naming ROADMAP item 16.

Apart from ``direct`` (by definition it contracts each site column into
one tensor, then canonizes and truncates), no method forms a site
column's fat tensor: zip-up carries a (chi_new, chi, w) tensor down the
chain, and dm eigendecomposes (chi_new d)-sized density matrices.
"""

import collections

import torch

from ...utils import check_opt
from ..core import (
    Tensor,
    TensorNetwork,
    _deferred,
    bonds,
    rand_uuid,
    tensor_contract,
)
from .core import MatrixProductState


def enforce_1d_like(tn, site_tags=None, fix_bonds=True, inplace=False):
    """Check that ``tn`` is 1D-like: every tensor has exactly one of
    ``site_tags``, no index is a hyper index, and bonds join the same or
    neighbouring columns; a longer bond is threaded through identity
    tensors with ``fix_bonds``. Contracts nothing."""
    tn = tn if inplace else tn.copy()
    if site_tags is None:
        site_tags = tn.site_tags
    site_of_tag = {tag: i for i, tag in enumerate(site_tags)}

    def which_site(tid):
        found = [site_of_tag[tag] for tag in tn.tensor_map[tid].tags
                 if tag in site_of_tag]
        if len(found) != 1:
            raise ValueError(f"tensor {tn.tensor_map[tid]} should have "
                             f"exactly one site tag, has {len(found)}")
        return found[0]

    for ix in list(tn.ind_map):
        tids = tuple(tn.ind_map.get(ix, ()))
        if len(tids) <= 1:
            continue
        if len(tids) > 2:
            raise ValueError(f"TN has a hyper index {ix}, cannot treat as "
                             f"1D-like.")
        tida, tidb = tids
        sa, sb = which_site(tida), which_site(tidb)
        if sa > sb:
            sa, sb, tida, tidb = sb, sa, tidb, tida
        if sb - sa > 1:
            if not fix_bonds:
                raise ValueError(f"bond {ix} connects non-neighbouring "
                                 f"sites {sa} and {sb} and fix_bonds=False")
            ta = tn.tensor_map[tida]
            eye = torch.eye(ta.ind_size(ix), dtype=ta.dtype,
                            device=ta.data.device)
            ixl = ix
            for i in range(sa + 1, sb):
                ixr = rand_uuid()
                tn.add_tensor(Tensor(eye, inds=(ixl, ixr),
                                     tags=site_tags[i]))
                ixl = ixr
            tn.tensor_map[tidb].reindex_({ix: ixl})
    return tn


def _site_groups(tn, site_tags):
    """The tensors of each site column, in order."""
    return [list(tn.select_tensors(tag, "any")) for tag in site_tags]


def _site_outer_inds(tn, site_tags):
    """The outer indices of each column."""
    outer = set(tn.outer_inds())
    return [tuple({ix for t in tn.select_tensors(tag, "any")
                   for ix in t.inds if ix in outer}) for tag in site_tags]


def _form_final_tn(tn, ts, site_tags, normalize=False, sweep_reverse=False,
                   inplace=False):
    """The per-site tensors ``ts`` as the result network."""
    if sweep_reverse:
        ts = list(reversed(ts))
        site_tags = tuple(reversed(site_tags))
    for tag, t in zip(site_tags, ts):
        t.drop_tags()
        t.add_tag(tag)
    if normalize:
        # the sweep leaves the canonical center at ts[0]
        t0 = ts[0]
        t0.modify(data=t0.data / torch.linalg.norm(t0.data.reshape(-1)))
    if inplace:
        for tid in tuple(tn.tensor_map):
            tn._pop_tensor(tid)
        for t in ts:
            tn.add_tensor(t)
        return tn
    new = TensorNetwork(ts, virtual=True)
    if hasattr(tn, "_site_tag_id"):
        new.view_like_(tn)
    return new


def _canonize_and_truncate(ts, max_bond, cutoff, cutoff_mode="rsum2"):
    """Right-canonize the chain ``ts`` by LQs, then truncate it left to
    right by SVDs."""
    L = len(ts)
    ts = list(ts)
    for i in range(L - 1, 0, -1):
        shared = tuple(bonds(ts[i - 1], ts[i]))
        Lf, Q = ts[i].split(left_inds=shared, method="lq", get="tensors",
                            cutoff=-1.0)
        ts[i] = Q
        ts[i - 1] = tensor_contract(ts[i - 1], Lf, preserve_tensor=True,
                                    drop_tags=True)
    for i in range(L - 1):
        shared = tuple(bonds(ts[i], ts[i + 1]))
        U, sVH = ts[i].split(
            left_inds=None, right_inds=shared, method="svd",
            absorb="right", max_bond=max_bond, cutoff=cutoff,
            cutoff_mode=cutoff_mode, get="tensors",
        )
        ts[i] = U
        ts[i + 1] = tensor_contract(sVH, ts[i + 1], preserve_tensor=True,
                                    drop_tags=True)
    return ts


def _compress_direct_tn(tn, site_tags, site_inds, max_bond, cutoff,
                        cutoff_mode="rsum2", **kwargs):
    """'direct': contract each column into one tensor, right-canonize,
    truncate left to right."""
    ts = [g[0].copy() if len(g) == 1 else
          tensor_contract(*g, preserve_tensor=True, drop_tags=True)
          for g in _site_groups(tn, site_tags)]
    return _canonize_and_truncate(ts, max_bond, cutoff, cutoff_mode)


def _compress_dm_tn(tn, site_tags, site_inds, max_bond, cutoff,
                    cutoff_mode="rsum1", **kwargs):
    """Density-matrix compression in the squared picture: left norm
    environments column by column, then a right-to-left sweep that
    eigendecomposes each local reduced density matrix."""
    L = len(site_tags)
    groups = _site_groups(tn, site_tags)
    # the conjugate layer: inner indices mangled, site indices kept, so
    # that a ket column times a bra column forms the norm
    bra = tn.conj()
    bra.reindex_({ix: rand_uuid() for ix in tn.inner_inds()})
    bgroups_closed = _site_groups(bra, site_tags)
    # the bra columns with their site indices opened (primed)
    binds, bgroups = [], []
    for i in range(L):
        col_map = {kix: rand_uuid() for kix in site_inds[i]}
        binds.append(tuple(col_map[k] for k in site_inds[i]))
        bgroups.append([t.reindex(col_map) for t in bgroups_closed[i]])

    left_envs = {1: tensor_contract(*groups[0], *bgroups_closed[0],
                                    preserve_tensor=True, drop_tags=True)}
    for i in range(2, L):
        left_envs[i] = tensor_contract(
            left_envs[i - 1], *groups[i - 1], *bgroups_closed[i - 1],
            preserve_tensor=True, drop_tags=True)

    new_kbond = collections.defaultdict(rand_uuid)
    new_bbond = collections.defaultdict(rand_uuid)
    Us = [None] * L
    re_ket = re_bra = None
    for i in range(L - 1, 0, -1):
        rho_tensors = [left_envs[i], *groups[i], *bgroups[i]]
        left_inds, right_inds = list(site_inds[i]), list(binds[i])
        if re_ket is not None:
            rho_tensors.extend((re_ket, re_bra))
            left_inds.append(new_kbond[i + 1])
            right_inds.append(new_bbond[i + 1])
        rho = tensor_contract(*rho_tensors, preserve_tensor=True,
                              drop_tags=True,
                              output_inds=(*left_inds, *right_inds))
        U, s, UH = rho.split(
            left_inds=left_inds, right_inds=right_inds, method="eigh",
            positive=1, absorb=None, max_bond=max_bond, cutoff=cutoff,
            cutoff_mode=cutoff_mode, get="tensors",
        )
        (bix,) = s.inds
        U.reindex_({bix: new_kbond[i]})
        UH.reindex_({bix: new_bbond[i]})
        Us[i] = U
        rkt = [*groups[i], U.conj()]
        rbt = [*bgroups[i], UH.conj()]
        if re_ket is not None:
            rkt.append(re_ket)
            rbt.append(re_bra)
        re_ket = tensor_contract(*rkt, preserve_tensor=True, drop_tags=True)
        re_bra = tensor_contract(*rbt, preserve_tensor=True, drop_tags=True)
    Us[0] = tensor_contract(*groups[0], re_ket, preserve_tensor=True,
                            drop_tags=True)
    return Us


def _compress_zipup_tn(tn, site_tags, site_inds, max_bond, cutoff,
                       cutoff_mode="rsum2", canonize=True, oversample=False,
                       **kwargs):
    """Zip-up compression (arXiv:1002.1305): pseudo-canonicalize towards
    the last site, then sweep right to left carrying the U s factor
    through each column."""
    L = len(site_tags)
    if canonize:
        tn = tn.canonize_around(site_tags[-1])
    groups = _site_groups(tn, site_tags)
    mb = None if max_bond is None else max_bond * (2 if oversample else 1)
    ts = [None] * L
    Us = bix = None
    for i in range(L - 1, 0, -1):
        C = tensor_contract(*((Us,) if Us is not None else ()), *groups[i],
                            preserve_tensor=True, drop_tags=True)
        right_inds = list(site_inds[i]) + ([bix] if bix is not None else [])
        bix = rand_uuid()
        Us, VH = C.split(
            left_inds=None, right_inds=right_inds, bond_ind=bix,
            method="svd", absorb="left", max_bond=mb, cutoff=cutoff,
            cutoff_mode=cutoff_mode, get="tensors",
        )
        Us.drop_tags()
        ts[i] = VH
    ts[0] = tensor_contract(Us, *groups[0], preserve_tensor=True,
                            drop_tags=True)
    if oversample and max_bond is not None:
        ts = _canonize_and_truncate(ts, max_bond, cutoff)
    return ts


def _compress_zipup_oversample_tn(tn, site_tags, site_inds, max_bond,
                                  cutoff, **kwargs):
    return _compress_zipup_tn(tn, site_tags, site_inds, max_bond, cutoff,
                              oversample=True, **kwargs)


_COMPRESS_METHODS = {
    "direct": _compress_direct_tn,
    "dm": _compress_dm_tn,
    "zipup": _compress_zipup_tn,
    "zipup-oversample": _compress_zipup_oversample_tn,
}
_DEFERRED_METHODS = ("fit", "src", "src-oversample", "projector", "bidm")


def _compress_method(method):
    check_opt("method", method, (*_COMPRESS_METHODS, *_DEFERRED_METHODS))
    if method in _DEFERRED_METHODS:
        raise _deferred(16, f"1D compression method {method!r} "
                            f"(tn1d/compress.py)")
    return _COMPRESS_METHODS[method]


def tensor_network_1d_compress(tn, max_bond=None, cutoff=1e-10, method="dm",
                               site_tags=None, site_inds=None,
                               normalize=False, sweep_reverse=False,
                               inplace=False, **kwargs):
    """Compress a 1D-like network to one tensor per site with bounded
    bond dimension (reference dispatcher tn1d/compress.py:2815)."""
    fn = _compress_method(method)
    site_tags = tuple(tn.site_tags if site_tags is None else site_tags)
    if sweep_reverse:
        site_tags = tuple(reversed(site_tags))
    tn1d = enforce_1d_like(tn, site_tags=site_tags, inplace=inplace)
    if site_inds is None:
        site_inds = _site_outer_inds(tn1d, site_tags)
    else:
        site_inds = [(si,) if isinstance(si, str) else tuple(si)
                     for si in site_inds]
    ts = fn(tn1d, site_tags, site_inds, max_bond=max_bond, cutoff=cutoff,
            **kwargs)
    return _form_final_tn(tn if inplace else tn1d, ts, site_tags,
                          normalize=normalize, sweep_reverse=sweep_reverse,
                          inplace=inplace)


# ---------------------------------------------------------------------------
# MPO x MPS
# ---------------------------------------------------------------------------


def _lazy_mpo_mps_tn(mpo, mps):
    """The two-layer network of ``mpo`` on ``mps``; its outer indices are
    the MPO's upper ones."""
    A, x = mpo.copy(), mps.copy()
    x.reindex_sites_("__apply{}__")
    A.reindex_lower_sites_("__apply{}__")
    tn = TensorNetwork((), virtual=True)
    tn.add_tensor_network(x, virtual=True, check_collisions=False)
    tn.add_tensor_network(A, virtual=True, check_collisions=False)
    return tn


def mps_gate_with_mpo_lazy(mps, mpo):
    """Apply without compression (the bonds multiply)."""
    return mpo.apply(mps)


def mps_gate_with_mpo_direct(mps, mpo, max_bond=None, cutoff=1e-10,
                             **kwargs):
    out = mpo.apply(mps)
    out.compress(max_bond=max_bond, cutoff=cutoff)
    return out


def _chain_to_mps(ts, mps, mpo):
    """An ordered chain of site tensors (outer index: the MPO's upper
    one) as a :class:`MatrixProductState` like ``mps``."""
    L = mps.L
    arrays = []
    for i, t in enumerate(ts):
        lb = tuple(bonds(ts[i - 1], t)) if i > 0 else ()
        rb = tuple(bonds(t, ts[i + 1])) if i < L - 1 else ()
        arrays.append(t.transpose(*lb, *rb, mpo.upper_ind(i)).data)
    return MatrixProductState(arrays, shape="lrp",
                              site_ind_id=mps._site_ind_id,
                              site_tag_id=mps._site_tag_id)


def _apply_via(method):
    def fn(mps, mpo, max_bond=None, cutoff=1e-10, **kwargs):
        compress = _compress_method(method)
        site_tags = tuple(mps.site_tag(i) for i in range(mps.L))
        site_inds = [(mpo.upper_ind(i),) for i in range(mps.L)]
        tn1d = enforce_1d_like(_lazy_mpo_mps_tn(mpo, mps),
                               site_tags=site_tags)
        ts = compress(tn1d, site_tags, site_inds, max_bond=max_bond,
                      cutoff=cutoff, **kwargs)
        out = _chain_to_mps(ts, mps, mpo)
        out.reindex_sites_(mps._site_ind_id)
        return out

    return fn


mps_gate_with_mpo_dm = _apply_via("dm")
mps_gate_with_mpo_zipup = _apply_via("zipup")
mps_gate_with_mpo_zipup_oversample = _apply_via("zipup-oversample")

_APPLY_METHODS = {
    "direct": mps_gate_with_mpo_direct,
    "dm": mps_gate_with_mpo_dm,
    "zipup": mps_gate_with_mpo_zipup,
    "zipup-oversample": mps_gate_with_mpo_zipup_oversample,
}


def mps_gate_with_mpo(mps, mpo, max_bond=None, cutoff=1e-10, method="dm",
                      **kwargs):
    """Apply an MPO to an MPS with compression, by ``method``."""
    if method not in _APPLY_METHODS:
        _compress_method(method)
    return _APPLY_METHODS[method](mps, mpo, max_bond=max_bond,
                                  cutoff=cutoff, **kwargs)
