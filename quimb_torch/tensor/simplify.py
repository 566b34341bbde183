"""TN simplification pipeline: local graph rewrites that shrink a
network before contraction.

Port of quimb_tpu's ``tensor/simplify.py`` to torch, a port of the
reference pipeline (``full_simplify``
tensor_core.py:11467 composing ``rank_simplify`` :10719,
``diagonal_reduce`` :10922, ``antidiag_gauge`` :11008, ``column_reduce``
:11093, ``split_simplify`` :11164, ``loop_simplify`` :11346,
``pair_simplify`` :11240, ``hyperinds_resolve`` :11651).

These are host-side *setup-time* graph rewrites: ``full_simplify``
pulls the network's arrays to the host once, rewrites them in numpy and
puts the survivors back on the device their network came from (host
leaves stay on the host); the rewritten network then contracts as a
leaner chain of device products. Hyper-indices (one index on 3+ tensors)
are supported throughout, which is what makes the circuit amplitude path
(diagonal gates become COPY hyper-edges) efficient.
"""

import collections
import itertools

import numpy as np
import torch

from ..ops.backend import to_device, to_host
from ..utils import oset
from . import array_ops as ar
from .core import COPY_tensor, Tensor, rand_uuid, tensor_contract


def _output_inds_of(tn, output_inds):
    if output_inds is None:
        return oset(tn.outer_inds())
    return oset(output_inds)


def rank_simplify(tn, output_inds=None, inplace=False, equalize_norms=False,
                  cache=None, max_combinations=500):
    """Contract pairs of tensors whenever doing so does not increase
    the total rank (reference ``rank_simplify`` tensor_core.py:10719).
    This absorbs scalars, vectors, and 'free' matmuls."""
    tn = tn if inplace else tn.copy()
    output_inds = _output_inds_of(tn, output_inds)
    output_set = set(output_inds)

    # local index-size cache: sizes are immutable per index name, and
    # tn.ind_size is a multi-lookup chain — this loop is the hottest
    # host-side path in circuit sampling
    sizes = {}

    def ind_size(ix):
        sz = sizes.get(ix)
        if sz is None:
            sizes[ix] = sz = tn.ind_size(ix)
        return sz

    ind_map = tn.ind_map
    tensor_map = tn.tensor_map

    # per-tid size cache (Tensor.size recomputes prod(shape) per call,
    # and the candidate loop below reads sizes ~10x per tensor)
    tsizes = {}

    def tensor_size(xtid, xt):
        sz = tsizes.get(xtid)
        if sz is None:
            tsizes[xtid] = sz = xt.size
        return sz

    queue = list(tensor_map)
    while queue:
        tid = queue.pop()
        if tid not in tensor_map:
            continue
        t = tensor_map[tid]
        t_inds = t.inds

        # rank-0/1 tensors: absorb into any neighbor. An ordered set: the
        # first of equal candidates wins, so the order of the network's
        # maps, not the process's string hashes, breaks ties, and every
        # process derives the same network
        neighbors = oset()
        for ix in t_inds:
            neighbors.update(ind_map[ix])
        neighbors.discard(tid)

        if not t_inds and tn.num_tensors > 1:
            # scalar: multiply into any tensor
            tn._pop_tensor(tid)
            other = next(iter(tensor_map.values()))
            other.modify(apply=lambda d: d * t.data)
            continue

        t_ind_set = set(t_inds)
        t_size = tensor_size(tid, t)
        t_plain = len(t_ind_set) == len(t_inds)
        best = None
        for otid in neighbors:
            o = tensor_map[otid]
            o_inds = o.inds
            o_ind_set = set(o_inds)
            shared = t_ind_set & o_ind_set
            o_size = tensor_size(otid, o)
            cap = max(t_size, o_size)
            if t_plain and len(o_ind_set) == len(o_inds):
                # no intra-tensor repeats: the output size is
                # t_size * o_size with every shared index divided out
                # once (it appeared in both) and contracted indices
                # divided out twice — O(|shared|), no allocation, vs
                # scanning the whole index union per candidate (this
                # loop dominates host-side circuit simplification)
                out_sz = t_size * o_size
                for ix in shared:
                    d = ind_size(ix)
                    out_sz //= d
                    if not (ix in output_set or len(ind_map[ix]) > 2):
                        out_sz //= d
                if out_sz <= cap and (best is None or out_sz < best[0]):
                    best = (out_sz, otid)
                continue
            # output size of the contraction
            out_sz = 1
            for ix in dict.fromkeys(t_inds + o_inds):
                if ix in shared:
                    # shared index: only contributes to the output if
                    # kept (output / hyper / intra-tensor repeat)
                    if not (
                        ix in output_set
                        or len(ind_map[ix]) > 2
                        or t_inds.count(ix) + o_inds.count(ix) > 2
                    ):
                        continue
                out_sz *= ind_size(ix)
                if out_sz > cap:
                    break
            else:
                if best is None or out_sz < best[0]:
                    best = (out_sz, otid)
        if best is not None:
            _, otid = best
            o = tn.tensor_map[otid]
            tn._pop_tensor(tid)
            tn._pop_tensor(otid)
            # determine output inds (hyper aware)
            freq = collections.Counter(t.inds + o.inds)
            new_out = []
            for ix in dict.fromkeys(t.inds + o.inds):
                if ix in output_inds or ix in tn.ind_map or \
                        freq[ix] == 1:
                    new_out.append(ix)
            new = tensor_contract(
                t, o, output_inds=tuple(new_out), preserve_tensor=True
            )
            new_tid = tn.add_tensor(new, virtual=True)
            if equalize_norms:
                tn.strip_exponent(new_tid)
            queue.append(new_tid)
            queue.extend(
                otid2 for ix in new.inds
                for otid2 in tn.ind_map.get(ix, ())
            )
    return tn


def diagonal_reduce(tn, output_inds=None, atol=1e-12, inplace=False,
                    cache=None):
    """Find tensors diagonal along pairs of axes and replace the pair
    of indices with a single (hyper) index (reference
    ``diagonal_reduce`` tensor_core.py:10922)."""
    tn = tn if inplace else tn.copy()
    output_inds = _output_inds_of(tn, output_inds)

    changed = True
    while changed:
        changed = False
        for tid, t in tuple(tn.tensor_map.items()):
            axes = ar.find_diag_axes(t.data, atol=atol)
            if axes is None:
                continue
            i, j = axes
            ixi, ixj = t.inds[i], t.inds[j]
            if ixi == ixj:
                continue
            # keep output inds as names
            if ixj in output_inds:
                if ixi in output_inds:
                    continue
                ixi, ixj = ixj, ixi
                i, j = j, i
            # take diagonal of this tensor, rename ixj -> ixi everywhere
            selector = {ixj: "__diag__"}
            label = {}
            for ix in t.inds:
                label.setdefault(ix, len(label))
            # new tensor: diagonal along (i, j)
            new_inds = tuple(ix for k, ix in enumerate(t.inds) if k != j)
            la = [label[ix] if k != j else label[ixi]
                  for k, ix in enumerate(t.inds)]
            lo = [label[ix] for ix in new_inds]
            new_data = np.einsum(to_host(t.data), la, lo)
            if isinstance(t.data, torch.Tensor):
                new_data = ar.like(new_data, t.data)
            t.modify(data=new_data, inds=new_inds, left_inds=None)
            # reindex all other tensors ixj -> ixi (making a hyper edge)
            for otid in tuple(tn.ind_map.get(ixj, ())):
                tn.tensor_map[otid].reindex_({ixj: ixi})
            changed = True
    return tn


def antidiag_gauge(tn, output_inds=None, atol=1e-12, inplace=False,
                   cache=None):
    """Flip anti-diagonal axes so they become diagonal (then
    ``diagonal_reduce`` can act) (reference ``antidiag_gauge``
    tensor_core.py:11008)."""
    tn = tn if inplace else tn.copy()
    output_inds = _output_inds_of(tn, output_inds)

    for tid, t in tuple(tn.tensor_map.items()):
        axes = ar.find_antidiag_axes(t.data, atol=atol)
        if axes is None:
            continue
        i, j = axes
        ixi, ixj = t.inds[i], t.inds[j]
        # flip index ixj on ALL tensors sharing it (a gauge — only valid
        # if ixj appears exactly twice and isn't an output)
        flip = ixj if ixj not in output_inds else (
            ixi if ixi not in output_inds else None
        )
        if flip is None:
            continue
        if len(tn.ind_map[flip]) != 2:
            continue
        for otid in tn.ind_map[flip]:
            if otid != tid:
                tn.tensor_map[otid].flip_(flip)
        t.flip_(flip)
    return tn


def column_reduce(tn, output_inds=None, atol=1e-12, inplace=False,
                  cache=None):
    """Find axes with a single nonzero slice and slice them
    (reference ``column_reduce`` tensor_core.py:11093)."""
    tn = tn if inplace else tn.copy()
    output_inds = _output_inds_of(tn, output_inds)

    changed = True
    while changed:
        changed = False
        for tid, t in tuple(tn.tensor_map.items()):
            found = ar.find_columns(t.data, atol=atol)
            if found is None:
                continue
            ax, col = found
            ix = t.inds[ax]
            if ix in output_inds or t.ind_size(ix) == 1:
                continue
            # select that column on every tensor holding ix
            for otid in tuple(tn.ind_map.get(ix, ())):
                tn.tensor_map[otid].isel_({ix: col})
            changed = True
    return tn


def split_simplify(tn, atol=1e-12, inplace=False, cache=None,
                   **split_opts):
    """Split tensors that are exactly low-rank across some bipartition
    (reference ``split_simplify`` tensor_core.py:11164).

    ``cache`` (a set) records tensors already found unsplittable so the
    fixpoint loop in ``full_simplify`` doesn't re-SVD them every pass.
    The rank probes run as plain ``numpy`` svdvals when the data is
    host-resident — this is a setup-time pass over many tiny tensors,
    where per-op dispatch would dominate."""
    tn = tn if inplace else tn.copy()
    for tid, t in tuple(tn.tensor_map.items()):
        if t.ndim < 3:
            continue
        if len(set(t.inds)) != t.ndim:
            # repeated index within one tensor (e.g. the marginal
            # diagonal trick reindexes bra -> ket on a tensor holding
            # both): no valid bipartition, and diag_simplify ('D')
            # collapses it anyway
            continue
        ckey = (tid, t.shape)
        if cache is not None and ckey in cache:
            continue
        data = t.data if isinstance(t.data, np.ndarray) else None
        split_done = False
        # try bipartitions: each single index vs rest
        for k in range(t.ndim):
            left = (t.inds[k],)
            dl = t.ind_size(t.inds[k])
            if dl <= 1:
                continue
            if data is not None:
                mat = np.reshape(np.moveaxis(data, k, 0), (dl, -1))
                s = np.linalg.svd(mat, compute_uv=False)
            else:
                s = t.split(left_inds=left, get="values", cutoff=0.0)
            s = to_host(s)
            rank = int(np.sum(s > atol * float(s[0])))
            if rank < min(dl, t.size // dl):
                tl, tr = t.split(
                    left_inds=left, get="tensors", cutoff=atol,
                    cutoff_mode="rel", absorb="both",
                )
                tn._pop_tensor(tid)
                tn.add_tensor(tl, virtual=True)
                tn.add_tensor(tr, virtual=True)
                split_done = True
                break
        if not split_done and cache is not None:
            cache.add(ckey)
    return tn


def pair_simplify(tn, cutoff=1e-12, output_inds=None, max_inds=10,
                  inplace=False, **split_opts):
    """Contract and re-split neighboring pairs when it reduces total
    size (reference ``pair_simplify`` tensor_core.py:11240)."""
    tn = tn if inplace else tn.copy()
    output_inds = _output_inds_of(tn, output_inds)

    for ix in tuple(tn.inner_inds()):
        tids = tn.ind_map.get(ix)
        if tids is None or len(tids) != 2:
            continue
        tid1, tid2 = tids
        t1, t2 = tn.tensor_map[tid1], tn.tensor_map[tid2]
        if t1.ndim + t2.ndim - 2 > max_inds:
            continue
        shared = [i for i in t1.inds if i in t2.inds]
        l_inds = [i for i in t1.inds if i not in shared]
        r_inds = [i for i in t2.inds if i not in shared]
        if not l_inds or not r_inds:
            continue
        theta = tensor_contract(
            t1, t2, output_inds=(*l_inds, *r_inds), preserve_tensor=True
        )
        s = to_host(theta.split(left_inds=l_inds, get="values",
                                cutoff=0.0))
        rank = int(np.sum(s > cutoff * float(s[0])))
        old_sz = t1.size + t2.size
        dl = int(np.prod([t1.ind_size(i) for i in l_inds]))
        dr = int(np.prod([t2.ind_size(i) for i in r_inds]))
        new_sz = rank * (dl + dr)
        if new_sz < old_sz:
            tl, tr = theta.split(
                left_inds=l_inds, get="tensors", cutoff=cutoff,
                cutoff_mode="rel", absorb="both", bond_ind=ix,
            )
            tl.modify(tags=t1.tags)
            tr.modify(tags=t2.tags)
            tn._pop_tensor(tid1)
            tn._pop_tensor(tid2)
            tn.add_tensor(tl, tid=tid1, virtual=True)
            tn.add_tensor(tr, tid=tid2, virtual=True)
    return tn


def loop_simplify(tn, cutoff=1e-12, max_loop_length=None, inplace=False,
                  **split_opts):
    """Contract and compress small loops (reference ``loop_simplify``
    tensor_core.py:11346). Currently handles 2-cycles (double bonds
    between pairs are fused by rank_simplify) and triangle loops."""
    tn = tn if inplace else tn.copy()
    # find triangles: three tensors pairwise connected, in the order of
    # the network's maps (ordered sets, as in rank_simplify)
    adj = {}
    for ix, tids in tn.ind_map.items():
        if len(tids) == 2:
            a, b = tuple(tids)
            adj.setdefault(a, oset()).add(b)
            adj.setdefault(b, oset()).add(a)
    seen = {}
    for a in list(adj):
        for b in adj.get(a, ()):
            for c in adj.get(b, ()):
                if c == a or c not in adj or a not in adj[c]:
                    continue
                tri = frozenset((a, b, c))
                if tri in seen or len(tri) != 3:
                    continue
                seen[tri] = (a, b, c)
    # triangles are contracted if beneficial
    for tri in seen.values():
        if not all(t in tn.tensor_map for t in tri):
            continue
        ts = [tn.tensor_map[t] for t in tri]
        freq = collections.Counter(itertools.chain(*(t.inds for t in ts)))
        out = [ix for ix, c in freq.items()
               if c == 1 or len(tn.ind_map[ix]) > c]
        out_sz = 1
        for ix in out:
            out_sz *= tn.ind_size(ix)
        if out_sz <= sum(t.size for t in ts):
            for t in tri:
                tn._pop_tensor(t)
            new = tensor_contract(*ts, output_inds=tuple(out),
                                  preserve_tensor=True)
            tn.add_tensor(new, virtual=True)
    return tn


def hyperinds_resolve(tn, mode="dense", sorter=None, inplace=False,
                      output_inds=None):
    """Convert hyper indices (shared by 3+ tensors) back into explicit
    COPY tensors (reference ``hyperinds_resolve`` tensor_core.py:11651),
    needed before exporting to strictly-binary contractors. Each COPY
    tensor lies where the network's arrays lie, in their dtype."""
    tn = tn if inplace else tn.copy()
    output_inds = _output_inds_of(tn, output_inds)
    for ix in tuple(tn.ind_map):
        tids = tn.ind_map[ix]
        n_legs = sum(
            tn.tensor_map[tid].inds.count(ix) for tid in tids
        ) + (1 if ix in output_inds else 0)
        if n_legs <= 2:
            continue
        d = tn.ind_size(ix)
        new_names = []
        for tid in tuple(tids):
            t = tn.tensor_map[tid]
            new_ix = rand_uuid()
            t.reindex_({ix: new_ix})
            new_names.append(new_ix)
        if ix in output_inds:
            new_names.append(ix)
        tn.add_tensor(_copy_like(d, tuple(new_names), tn), virtual=True)
    return tn


def _copy_like(d, inds, tn):
    """A COPY tensor of size ``d`` on ``inds``, a host array when the
    network's arrays are host arrays, else on their device."""
    ref = next(iter(tn.tensor_map.values())).data
    if isinstance(ref, torch.Tensor):
        return COPY_tensor(d, inds, dtype=ref.dtype, device=ref.device)
    data = np.zeros((d,) * len(inds), dtype=ref.dtype)
    data[(np.arange(d),) * len(inds)] = 1.0
    return Tensor(data, inds=inds)


_FULL_SIMPLIFY_FUNCS = {
    "D": diagonal_reduce,
    "R": rank_simplify,
    "A": antidiag_gauge,
    "C": column_reduce,
    "S": split_simplify,
    "L": loop_simplify,
    "P": pair_simplify,
}


def full_simplify(
    tn,
    seq="ADCR",
    output_inds=None,
    atol=1e-12,
    equalize_norms=False,
    cache=True,
    inplace=False,
    progbar=False,
    rank_simplify_opts=None,
    loop_simplify_opts=None,
    split_simplify_opts=None,
    custom_methods=(),
    **kwargs,
):
    """Repeatedly apply the rewrites in ``seq`` until the network stops
    shrinking (reference ``full_simplify`` tensor_core.py:11467).
    Default sequence 'ADCR'; use 'ADCRS' / 'ADCRSL' for more effort.

    The rewrites run in numpy on the host. Tensors that were torch
    tensors go back to the device of the network's first torch tensor
    afterwards, in their own dtype."""
    from ..ops.contraction import contract_backend

    tn = tn if inplace else tn.copy()
    if output_inds is None:
        output_inds = tn.outer_inds()

    old_nt, old_ni = -1, -1
    nt, ni = tn.num_tensors, tn.num_indices
    # the rewrites are host-side setup-time graph surgery on small
    # tensors: run their arithmetic through numpy rather than launching
    # a device operation per tiny op; pull any device leaves to the host
    # up front, and remember where they came from
    device = next((t.data.device for t in tn.tensor_map.values()
                   if isinstance(t.data, torch.Tensor)), None)

    def _hostify(a):
        if isinstance(a, np.ndarray) or a.__class__.__name__ == "PArray":
            return a
        return np.asarray(to_host(a))

    # shared across fixpoint passes: tensors already found unsplittable
    # by 'S' (re-SVD-ing every tensor every pass dominated large
    # circuit-sampling simplifies)
    split_cache = set() if cache else None
    with contract_backend("numpy"):
        tn.apply_to_arrays(_hostify)
        while (nt, ni) != (old_nt, old_ni) and nt > 1:
            for meth in seq:
                fn = _FULL_SIMPLIFY_FUNCS[meth]
                opts = {}
                if meth in "DAC":
                    opts["atol"] = atol
                if meth == "S":
                    opts["atol"] = atol
                    opts["cache"] = split_cache
                if meth in "DRACP":
                    opts["output_inds"] = output_inds
                fn(tn, inplace=True, **opts)
            old_nt, old_ni = nt, ni
            nt, ni = tn.num_tensors, tn.num_indices
    if device is not None:
        tn.apply_to_arrays(
            lambda a: a if a.__class__.__name__ == "PArray"
            else to_device(a, device=device)
        )
    if equalize_norms:
        tn.equalize_norms_()
    return tn
