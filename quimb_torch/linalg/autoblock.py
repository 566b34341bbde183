"""Symmetry-block detection for a dense eigendecomposition.

Port of ``quimb_tpu/linalg/autoblock.py`` (reference
``quimb/linalg/autoblock.py``: ``compute_blocks`` :16,
``eigensystem_autoblocked`` :225). Many physical operators conserve
charges and are permutation-similar to a block-diagonal matrix. The
blocks, the connected components of the nonzero structure, are found on
the host with a union-find (setup time); the blocks' eigendecompositions
run on the device, the blocks of one size stacked into one batched
``torch.linalg.eigh`` (quimb_tpu's ``vmap`` of ``eigh``).
"""

import collections

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.backend import resolve_device, to_device, to_host


def compute_blocks(ix, jx, d):
    """The charge sectors (matrix blocks) from the nonzero coordinates
    ``(ix, jx)`` of a ``d x d`` operator: the connected components of its
    sparsity graph (reference ``compute_blocks`` autoblock.py:16)."""
    parent = np.arange(d)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for i, j in zip(np.asarray(ix), np.asarray(jx)):
        ri, rj = find(int(i)), find(int(j))
        if ri != rj:
            parent[rj] = ri

    groups = collections.defaultdict(list)
    for i in range(d):
        groups[find(i)].append(i)
    return sorted(groups.values())


def _host_matrix(A, atol=1e-13):
    """(dense host array, nonzero rows, nonzero cols) of ``A``."""
    if sp.issparse(A):
        ix, jx = A.nonzero()
        return A.toarray(), np.asarray(ix), np.asarray(jx)
    A = to_host(A)
    ix, jx = np.nonzero(np.abs(A) > atol)
    return A, ix, jx


def eigensystem_autoblocked(A, sort=True, isherm=True, return_vecs=True,
                            atol=1e-13, device=None):
    """The eigendecomposition of ``A`` by its blocks (reference
    ``eigensystem_autoblocked`` autoblock.py:225): the charge sectors are
    found, each is solved by ``eigh`` (those of one size in one batched
    call on the device), and the results are scattered back. The result
    lies on ``A``'s device for a tensor, else on ``device`` (the GPU by
    default)."""
    if not isherm:
        raise ValueError(
            "autoblocking currently supports hermitian operators")
    device = A.device if isinstance(A, torch.Tensor) else \
        resolve_device(device)
    Ad, ix, jx = _host_matrix(A, atol=atol)
    d = Ad.shape[0]
    sectors = compute_blocks(ix, jx, d)

    el = np.zeros(d, dtype=float)
    ev = np.zeros((d, d), dtype=Ad.dtype) if return_vecs else None
    by_size = collections.defaultdict(list)
    for sec in sectors:
        by_size[len(sec)].append(sec)
    for size, secs in by_size.items():
        if size == 1:
            for (i,) in secs:
                el[i] = Ad[i, i].real
                if return_vecs:
                    ev[i, i] = 1.0
            continue
        blocks = to_device(np.stack([Ad[np.ix_(s, s)] for s in secs]),
                           device=device)
        bl, bv = (to_host(t) for t in torch.linalg.eigh(blocks))
        for s, lk, vk in zip(secs, bl, bv):
            s = np.asarray(s)
            el[s] = lk
            if return_vecs:
                ev[np.ix_(s, s)] = vk
    if sort:
        order = np.argsort(el)
        el = el[order]
        if return_vecs:
            ev = ev[:, order]
    el = to_device(el, device=device)
    if return_vecs:
        return el, to_device(ev, device=device)
    return el


__all__ = ["compute_blocks", "eigensystem_autoblocked"]
