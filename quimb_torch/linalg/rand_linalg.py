"""Randomized linear algebra: port of quimb_tpu's ``linalg/rand_linalg.py``
(reference ``quimb/linalg/rand_linalg.py``: ``rsvd`` :398,
``rsvd_iterate`` :173, ``estimate_rank`` :302, ``isvd``).

A fixed rank takes one range sketch with power iterations; a relative
cutoff grows an orthonormal range basis block by block (a QB iteration),
each new block orthogonalized against the basis so far, until the
captured spectrum crosses the cutoff. The sketches are drawn on the
matrix's device from a torch generator seeded by ``seed`` (quimb_tpu
seeds numpy draws from JAX keys, which torch cannot reproduce): compare
singular values across the packages, not factors.
"""

import math

import numpy as np
import torch

from ..gen.rand import _generator, _randn_from
from ..ops.backend import resolve_device
from ..ops.decomp import estimate_rank  # noqa: F401  (re-export)
from ..ops.decomp import _rand_range_finder, dag, safe_qr
from ..ops.decomp import safe_svd as _svd_kernel


def _as_matrix(A, device=None):
    if isinstance(A, torch.Tensor):
        return A
    return torch.as_tensor(np.asarray(A), device=resolve_device(device))


def _power_iterate(A, AH, G, q):
    """``q`` passes of ``A AH`` on the block ``G`` with stabilizing
    QRs."""
    Y = A @ G
    for _ in range(q):
        Q, _ = safe_qr(Y)
        Y = A @ (AH @ Q[..., :, :G.shape[-1]])
    return Y


def rsvd_iterate(A, eps, q=2, k_start=16, k_incr=1.5, k_max=None, AH=None,
                 seed=None):
    """Grow an orthonormal range basis ``Q`` block by block until the
    captured singular spectrum falls below ``eps`` relative to its
    largest value (reference ``rsvd_iterate`` rand_linalg.py:173).
    Returns ``(U, s, VH)`` of the captured range. Each block reads its
    spectrum's test to the host."""
    m, n = A.shape[-2:]
    full = min(m, n)
    k_max = full if k_max is None else min(k_max, full)
    AH = dag(A) if AH is None else AH
    gen = _generator(A.device, seed)
    Q = None
    k_step = max(int(k_start), 1)
    while True:
        G = _randn_from(gen, (n, k_step), A.real.dtype, 1.0, 0.0, "normal",
                        A.device).to(A.dtype)
        Y = _power_iterate(A, AH, G, q)
        if Q is not None:
            # power iteration concentrates Y on the captured directions:
            # orthogonalize twice against them
            Y = Y - Q @ (dag(Q) @ Y)
            Y = Y - Q @ (dag(Q) @ Y)
        Qnew = safe_qr(Y)[0][..., :, :k_step]
        if Q is not None:
            Qnew = safe_qr(Qnew - Q @ (dag(Q) @ Qnew))[0][..., :, :k_step]
        Q = Qnew if Q is None else torch.cat([Q, Qnew], dim=-1)
        k = Q.shape[-1]
        B = dag(Q) @ A
        s = torch.linalg.svdvals(B)
        if bool(torch.any(s < eps * s[..., :1])) or k >= k_max:
            U, s, VH = _svd_kernel(B)
            return Q @ U, s, VH
        k_step = min(max(int(math.ceil(k_step * k_incr)), 1), k_max - k)


def count_svdvals_needed(s, eps):
    """The number of singular values above the relative cutoff ``eps``
    (reference ``count_svdvals_needed``)."""
    s = torch.as_tensor(s)
    return int(torch.sum(s >= eps * s[..., 0]))


def rsvd(A, eps_or_k, compute_uv=True, q=2, p=0, k_max=None, k_start=16,
         k_incr=1.5, seed=None, device=None, **kwargs):
    """Randomized SVD (reference ``rsvd`` rand_linalg.py:398).

    ``eps_or_k``: an integer is the target rank (one sketch of ``k + p``
    columns); a float below 1 is a relative singular-value cutoff whose
    rank is found by :func:`rsvd_iterate`. ``q`` power iterations. A
    host array goes to ``device`` (the GPU unless given)."""
    A = _as_matrix(A, device)
    full = min(A.shape[-2:])
    if isinstance(eps_or_k, float) and eps_or_k < 1:
        U, s, VH = rsvd_iterate(A, eps_or_k, q=q, k_start=k_start,
                                k_incr=k_incr, k_max=k_max, seed=seed)
        k_out = min(count_svdvals_needed(s, eps_or_k), full)
    else:
        k = max(1, min(int(eps_or_k) + p, full))
        Q = _rand_range_finder(A, k, q, seed=seed)
        U, s, VH = _svd_kernel(dag(Q) @ A)
        U = Q @ U
        k_out = min(int(eps_or_k), full)
    U, s, VH = U[..., :, :k_out], s[..., :k_out], VH[..., :k_out, :]
    return (U, s, VH) if compute_uv else s


def isvd(A, eps_or_k=1e-6, **kwargs):
    """Interpolative-flavoured randomized SVD: the same sketches, named
    as the reference's ``isvd``."""
    return rsvd(A, eps_or_k, **kwargs)


__all__ = ["count_svdvals_needed", "estimate_rank", "isvd", "rsvd",
           "rsvd_iterate"]
