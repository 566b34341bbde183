"""Arbitrary-geometry tensor network compression (port of quimb_tpu's
``tensor/tnag/compress.py``, reference ``quimb/tensor/tnag/compress.py``):
reduce every bond of a TN with arbitrary connectivity to ``max_bond``,
using the simple (Vidal) gauges as the environment proxy. Each bond's
factors and projectors are computed on the device of its tensors; the
host reads the kept rank of each split, as quimb_tpu does.

Methods:

- ``superorthogonal``: converge the simple gauges, truncate each bond
  by its gauge spectrum, reinsert.
- ``local-early``: per-bond compress with environment gauges absorbed
  (truncation happens inside the gauged metric as each bond is
  visited).
- ``local-late``: converge gauges first, absorb them, then plain
  per-bond compression.
- ``projector``: insert oblique projectors computed from the
  gauge-reduced bond factors (no iteration).
"""

import torch

from ...ops import decomp
from ..core import tensor_compress_bond

__all__ = [
    "tensor_network_ag_compress",
    "tensor_network_ag_compress_superorthogonal",
    "tensor_network_ag_compress_local_early",
    "tensor_network_ag_compress_local_late",
    "tensor_network_ag_compress_projector",
]


def _bond_pairs(tn):
    for ix, tids in tuple(tn.ind_map.items()):
        if len(tids) == 2:
            yield ix, tuple(tids)


def _truncate_bond(tn, ix, k, gauges=None):
    """Keep the leading ``k`` entries of bond ``ix`` (gauge spectrum is
    sorted descending by construction)."""
    for tid in tuple(tn.ind_map[ix]):
        t = tn.tensor_map[tid]
        ax = t.inds.index(ix)
        sl = [slice(None)] * t.ndim
        sl[ax] = slice(0, k)
        t.modify(data=t.data[tuple(sl)])
    if gauges is not None and ix in gauges:
        s = gauges[ix][:k]
        gauges[ix] = s / torch.linalg.norm(s)


def _gauge_rank(s, max_bond, cutoff):
    k = int(s.shape[0])
    if cutoff:
        keep = int((s > cutoff * s[0]).sum())
        k = min(k, max(keep, 1))
    if max_bond is not None:
        k = min(k, max_bond)
    return k


def tensor_network_ag_compress_superorthogonal(
    tn, max_bond=None, cutoff=1e-10, inplace=False, max_iterations=100,
    tol=1e-9, **kwargs,
):
    tn = tn if inplace else tn.copy()
    gauges = {}
    tn.gauge_all_simple(
        max_iterations=max_iterations, tol=tol, inplace=True,
        gauges=gauges,
    )
    for ix, s in tuple(gauges.items()):
        k = _gauge_rank(s, max_bond, cutoff)
        if k < s.shape[0]:
            _truncate_bond(tn, ix, k, gauges)
    tn.gauge_simple_insert(gauges)
    return tn


def tensor_network_ag_compress_local_early(
    tn, max_bond=None, cutoff=1e-10, inplace=False, smudge=1e-12,
    sweeps=2, **kwargs,
):
    tn = tn if inplace else tn.copy()
    gauges = {}
    for _ in range(sweeps):
        for ix, tids in _bond_pairs(tn):
            t1, t2 = (tn.tensor_map[t] for t in tids)
            absorbed = []
            for t in (t1, t2):
                for ox in t.inds:
                    if ox != ix and ox in gauges:
                        t.multiply_index_diagonal_(
                            ox, gauges[ox] + smudge
                        )
                        absorbed.append((t, ox))
            if ix in gauges:
                sq = torch.sqrt(gauges[ix])
                t1.multiply_index_diagonal_(ix, sq)
                t2.multiply_index_diagonal_(ix, sq)
            out = tensor_compress_bond(
                t1, t2, absorb=None, max_bond=max_bond, cutoff=cutoff,
            )
            if len(out) == 3:
                _, s, _ = out
                gauges[ix] = s / torch.linalg.norm(s)
            for (t, ox) in absorbed:
                t.multiply_index_diagonal_(
                    ox, 1 / (gauges[ox] + smudge)
                )
    tn.gauge_simple_insert(gauges)
    return tn


def tensor_network_ag_compress_local_late(
    tn, max_bond=None, cutoff=1e-10, inplace=False, max_iterations=100,
    tol=1e-9, **kwargs,
):
    tn = tn if inplace else tn.copy()
    gauges = {}
    tn.gauge_all_simple(
        max_iterations=max_iterations, tol=tol, inplace=True,
        gauges=gauges,
    )
    tn.gauge_simple_insert(gauges)
    tn.compress_all_(max_bond=max_bond, cutoff=cutoff)
    return tn


def tensor_network_ag_compress_projector(
    tn, max_bond=None, cutoff=1e-10, inplace=False, smudge=1e-12,
    **kwargs,
):
    """One-shot oblique-projector compression: gauges approximate the
    environment, the bond projectors come from the gauge-reduced
    QR factors (reference :17)."""
    tn = tn if inplace else tn.copy()
    gauges = {}
    tn.gauge_all_simple(inplace=True, gauges=gauges)
    for ix, tids in _bond_pairs(tn):
        t1, t2 = (tn.tensor_map[t] for t in tids)
        if max_bond is not None and t1.ind_size(ix) <= max_bond:
            continue
        # reduce toward the bond inside the gauged metric
        absorbed = []
        for t in (t1, t2):
            for ox in t.inds:
                if ox != ix and ox in gauges:
                    t.multiply_index_diagonal_(ox, gauges[ox] + smudge)
                    absorbed.append((t, ox))
        sq = torch.sqrt(gauges[ix]) if ix in gauges else None
        if sq is not None:
            t1.multiply_index_diagonal_(ix, sq)
            t2.multiply_index_diagonal_(ix, sq)
        A1 = t1.transpose(
            *(x for x in t1.inds if x != ix), ix
        ).data
        A2 = t2.transpose(
            ix, *(x for x in t2.inds if x != ix)
        ).data
        m1 = A1.reshape(-1, A1.shape[-1])
        m2 = A2.reshape(A2.shape[0], -1)
        _, Rl = decomp.safe_qr(m1)
        # lq of m2: m2 = L Q via qr of m2^H
        _, R2 = decomp.safe_qr(m2.mH)
        Rr = R2.mH
        Pl, Pr = decomp.compute_oblique_projectors(
            Rl, Rr, max_bond=max_bond, cutoff=cutoff,
        )
        new1 = (m1 @ Pl).reshape(tuple(A1.shape[:-1]) + (Pl.shape[-1],))
        new2 = (Pr @ m2).reshape((Pr.shape[0],) + tuple(A2.shape[1:]))
        t1.modify(
            data=new1,
            inds=tuple(x for x in t1.inds if x != ix) + (ix,),
        )
        t2.modify(
            data=new2,
            inds=(ix,) + tuple(x for x in t2.inds if x != ix),
        )
        for (t, ox) in absorbed:
            t.multiply_index_diagonal_(ox, 1 / (gauges[ox] + smudge))
        # remove the sqrt-gauge we inserted on the bond itself: it is
        # now part of the compressed pair, so drop its stored gauge
        if ix in gauges:
            gauges.pop(ix)
    tn.gauge_simple_insert(gauges)
    return tn


_METHODS = {
    "superorthogonal": tensor_network_ag_compress_superorthogonal,
    "local-early": tensor_network_ag_compress_local_early,
    "local-late": tensor_network_ag_compress_local_late,
    "projector": tensor_network_ag_compress_projector,
}


def tensor_network_ag_compress(
    tn, max_bond=None, cutoff=1e-10, method="local-early", **kwargs,
):
    """Compress an arbitrary-geometry TN (reference
    ``tensor_network_ag_compress`` tnag/compress.py:580)."""
    return _METHODS[method](
        tn, max_bond=max_bond, cutoff=cutoff, **kwargs
    )
