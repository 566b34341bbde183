"""1D tensor network compression: the MPO x MPS application family.

Port of quimb_tpu's ``tensor/tn1d/compress.py`` (reference
``quimb/tensor/tn1d/compress.py``: ``tensor_network_1d_compress`` :2815,
direct :138, density-matrix :382, zip-up :667 and its oversampled form
:910, fit :2240, src :1273, ``mps_gate_with_mpo_*`` :2956-3215,
``enforce_1d_like`` :37; bidm from quimb's
``experimental/tensor_1d_gate``): the methods ``direct``, ``dm``,
``zipup``, ``zipup-oversample``, ``fit``, ``fit-zipup``, ``src``,
``src-oversample``, ``projector`` and ``bidm``.

Apart from ``direct`` (by definition it contracts each site column into
one tensor, then canonizes and truncates), no method forms a site
column's fat tensor: zip-up carries a (chi_new, chi, w) tensor down the
chain, dm eigendecomposes (chi_new d)-sized density matrices, src
sketches the left environments with a batch of random product states,
fit sweeps single-layer <guess|target> environments, projector inserts
oblique projectors from the 2x2 tensors around each bond, and bidm
computes every bond's projectors from the uncompressed network's norm
environments before contracting any column. src draws its sketches from
a torch generator seeded by ``seed + site`` on the network's device
(quimb_tpu draws them from JAX's PRNG, which torch cannot reproduce).
"""

import collections

import torch

from ...ops import decomp
from ...utils import check_opt
from ..core import Tensor, TensorNetwork, bonds, rand_uuid, tensor_contract
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


def _left_right_bonds(groups, i):
    """The bonds between columns i-1 and i, and between i and i+1."""
    lb, rb = [], []
    if i > 0:
        left = {ix for t in groups[i - 1] for ix in t.inds}
        lb = [ix for t in groups[i] for ix in t.inds if ix in left]
    if i < len(groups) - 1:
        right = {ix for t in groups[i + 1] for ix in t.inds}
        rb = [ix for t in groups[i] for ix in t.inds if ix in right]
    return tuple(dict.fromkeys(lb)), tuple(dict.fromkeys(rb))


def _compress_src_tn(tn, site_tags, site_inds, max_bond, cutoff=0.0,
                     seed=None, noise_dist="normal", **kwargs):
    """Successive randomized compression (arXiv:2504.06475): sketch the
    left environments with ``max_bond`` random product states sharing
    one batch index, then sweep right to left forming isometries by
    skinny QRs. The largest intermediate is O(B chi w)."""
    from ...gen.rand import randn

    L = len(site_tags)
    groups = _site_groups(tn, site_tags)
    if L == 1:
        return [tensor_contract(*groups[0], preserve_tensor=True,
                                drop_tags=True)]
    t0 = groups[0][0]
    B, bix = max_bond, rand_uuid()
    ws = [Tensor(randn((B, *(tn.ind_size(ix) for ix in site_inds[i])),
                       dtype=t0.dtype, dist=noise_dist,
                       seed=None if seed is None else seed + i,
                       device=t0.data.device),
                 inds=(bix, *site_inds[i])) for i in range(L)]
    # the left sketched environments; the batch index is a hyper index,
    # so the outputs are given
    LEs = [None] * L
    le = None
    for i in range(L - 1):
        le = tensor_contract(*((le,) if le is not None else ()), *groups[i],
                             ws[i], preserve_tensor=True, drop_tags=True,
                             output_inds=(bix,
                                          *_left_right_bonds(groups, i)[1]))
        LEs[i + 1] = le

    new = [None] * L
    re = None
    for i in range(L - 1, 0, -1):
        t = tensor_contract(LEs[i], *groups[i],
                            *((re,) if re is not None else ()),
                            preserve_tensor=True, drop_tags=True)
        Q, _ = t.split(left_inds=[ix for ix in t.inds if ix != bix],
                       right_inds=(bix,), method="qr", cutoff=-1.0,
                       get="tensors")
        new[i] = Q
        re = tensor_contract(*groups[i], Q.conj(),
                             *((re,) if re is not None else ()),
                             preserve_tensor=True, drop_tags=True)
    new[0] = tensor_contract(*groups[0], re, preserve_tensor=True,
                             drop_tags=True)
    if cutoff and cutoff > 0:
        new = _canonize_and_truncate(new, max_bond, cutoff)
    return new


def _compress_src_oversample_tn(tn, site_tags, site_inds, max_bond, cutoff,
                                max_bond_oversample=None, **kwargs):
    """src at a larger sketch (by default ``max(max_bond + 8,
    2 max_bond)``), then a canonical truncation to ``max_bond``."""
    if max_bond_oversample is None and max_bond is not None:
        max_bond_oversample = max(max_bond + 8, 2 * max_bond)
    ts = _compress_src_tn(tn, site_tags, site_inds, max_bond_oversample,
                          **kwargs)
    return _canonize_and_truncate(ts, max_bond, cutoff)


def _compress_fit_tn(tn, site_tags, site_inds, max_bond, cutoff,
                     max_iterations=2, guess="zipup", **kwargs):
    """One-site ALS fitting against the uncontracted target network, from
    a zip-up (or direct) guess; the environments are single-layer
    <guess|target> objects of size O(chi_new chi w)."""
    L = len(site_tags)
    groups = _site_groups(tn, site_tags)
    guess_fn = _compress_zipup_tn if guess == "zipup" else _compress_direct_tn
    ts = guess_fn(tn, site_tags, site_inds, max_bond, cutoff)

    for _ in range(max_iterations):
        envs = [None] * (L + 1)
        for i in range(L - 1, 0, -1):
            envs[i] = tensor_contract(
                ts[i].conj(), *groups[i],
                *((envs[i + 1],) if envs[i + 1] is not None else ()),
                preserve_tensor=True, drop_tags=True)
        lenv = None
        for i in range(L):
            B = tensor_contract(
                *groups[i], *((lenv,) if lenv is not None else ()),
                *((envs[i + 1],) if i < L - 1 else ()),
                preserve_tensor=True, drop_tags=True,
                output_inds=tuple(ts[i].inds))
            if i < L - 1:
                # orthogonalize the site, keeping the name of its bond to
                # site i+1 (whose tensor is recomputed from environments,
                # so R is dropped)
                (shared,) = bonds(ts[i], ts[i + 1])
                Q, _ = B.split(left_inds=None, right_inds=(shared,),
                               method="qr", cutoff=-1.0, get="tensors")
                newbix = next(ix for ix in Q.inds
                              if ix not in set(B.inds) - {shared})
                Q.reindex_({newbix: shared})
                ts[i] = Q
            else:
                ts[i] = B
            lenv = tensor_contract(ts[i].conj(), *groups[i],
                                   *((lenv,) if lenv is not None else ()),
                                   preserve_tensor=True, drop_tags=True)
    return ts


def _compress_projector_tn(tn, site_tags, site_inds, max_bond, cutoff,
                           canonize=True, **kwargs):
    """Local oblique projectors, as in CTMRG / HOTRG (reference
    ``mps_gate_with_mpo_projector`` tn1d/compress.py:3215): a compressor
    between each pair of neighbouring columns from the 2x2 tensors
    around the bond, then each column contracted and a canonical
    resweep."""
    tn = tn.copy()
    if canonize:
        tn.gauge_all_simple_(max_iterations=6, tol=1e-9)
        # the simple gauge strips the overall scale into the exponent
        tn.distribute_exponent()
    tn_calc = tn.copy()
    L = len(site_tags)
    for i in range(L - 1):
        tn_calc.insert_compressor_between_regions_(
            (site_tags[i],), (site_tags[i + 1],),
            new_ltags=(site_tags[i],), new_rtags=(site_tags[i + 1],),
            max_bond=max_bond, cutoff=cutoff, insert_into=tn)
    ts = [tensor_contract(*tn.select_tensors(tag, "any"),
                          preserve_tensor=True, drop_tags=True)
          for tag in site_tags]
    return _canonize_and_truncate(ts, max_bond, cutoff)


def _compress_bidm_tn(tn, site_tags, site_inds, max_bond, cutoff, **kwargs):
    """Bi-directional density-matrix compression: left and right norm
    environments of the uncompressed network are reduced to factors at
    every bond, the oblique projectors of all bonds come from those
    pairs, and only then are the columns contracted."""
    tnc = tn.copy()
    groups = _site_groups(tnc, site_tags)
    L = len(groups)
    outer = set(tnc.outer_inds())
    bmap = {ix: rand_uuid() for ix in tnc.ind_map if ix not in outer}
    bra = tnc.conj()
    bra.reindex_(bmap)
    bra_groups = _site_groups(bra, site_tags)
    bond_bix = [_left_right_bonds(groups, i)[1] for i in range(L - 1)]

    def reduced(i, kb, env, right):
        env = tensor_contract(*((env,) if env is not None else ()),
                              *(t.copy() for t in groups[i]),
                              *(t.copy() for t in bra_groups[i]),
                              preserve_tensor=True, drop_tags=True)
        bb = tuple(bmap[ix] for ix in kb)
        XX = env.to_dense(bb, kb) if right else env.to_dense(kb, bb)
        return env, decomp.squared_op_to_reduced_factor(XX, right=right)

    Rl, Rr = {}, {}
    env = None
    for i in range(L - 1):
        env, Rl[i] = reduced(i, bond_bix[i], env, True)
    env = None
    for i in range(L - 1, 0, -1):
        env, Rr[i - 1] = reduced(i, bond_bix[i - 1], env, False)

    for i in range(L - 1):
        kb = bond_bix[i]
        sizes = tuple(tnc.ind_size(ix) for ix in kb)
        Pl, Pr = decomp.compute_oblique_projectors(Rl[i], Rr[i],
                                                   max_bond=max_bond,
                                                   cutoff=cutoff)
        k = Pl.shape[-1]
        new_b = rand_uuid()
        lix = [rand_uuid() for _ in kb]
        rix = [rand_uuid() for _ in kb]
        for ix, nl, nr in zip(kb, lix, rix):
            for t in groups[i]:
                if ix in t.inds:
                    t.reindex_({ix: nl})
            for t in groups[i + 1]:
                if ix in t.inds:
                    t.reindex_({ix: nr})
        tnc.add_tensor(Tensor(Pl.reshape(*sizes, k), inds=(*lix, new_b),
                              tags=(site_tags[i],)))
        tnc.add_tensor(Tensor(Pr.reshape(k, *sizes), inds=(new_b, *rix),
                              tags=(site_tags[i + 1],)))
    return [tensor_contract(*tnc.select_tensors(tag, "any"),
                            preserve_tensor=True, drop_tags=True)
            for tag in site_tags]


_COMPRESS_METHODS = {
    "direct": _compress_direct_tn,
    "dm": _compress_dm_tn,
    "zipup": _compress_zipup_tn,
    "zipup-oversample": _compress_zipup_oversample_tn,
    "fit": _compress_fit_tn,
    "fit-zipup": _compress_fit_tn,
    "src": _compress_src_tn,
    "src-oversample": _compress_src_oversample_tn,
    "projector": _compress_projector_tn,
    "bidm": _compress_bidm_tn,
}


def _compress_method(method):
    check_opt("method", method, tuple(_COMPRESS_METHODS))
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
mps_gate_with_mpo_fit = _apply_via("fit")
mps_gate_with_mpo_src = _apply_via("src")
mps_gate_with_mpo_src_oversample = _apply_via("src-oversample")
mps_gate_with_mpo_projector = _apply_via("projector")
mps_gate_with_mpo_bidm = _apply_via("bidm")

_APPLY_METHODS = {
    "direct": mps_gate_with_mpo_direct,
    "dm": mps_gate_with_mpo_dm,
    "zipup": mps_gate_with_mpo_zipup,
    "zipup-oversample": mps_gate_with_mpo_zipup_oversample,
    "fit": mps_gate_with_mpo_fit,
    "src": mps_gate_with_mpo_src,
    "src-oversample": mps_gate_with_mpo_src_oversample,
    "projector": mps_gate_with_mpo_projector,
    "bidm": mps_gate_with_mpo_bidm,
}


def mps_gate_with_mpo(mps, mpo, max_bond=None, cutoff=1e-10, method="dm",
                      **kwargs):
    """Apply an MPO to an MPS with compression, by ``method``."""
    check_opt("method", method, tuple(_APPLY_METHODS))
    return _APPLY_METHODS[method](mps, mpo, max_bond=max_bond,
                                  cutoff=cutoff, **kwargs)
