"""Lanczos basis with full reorthogonalisation, for the DMRG local solve.

Port of ``quimb_tpu/linalg/lanczos.py:_norm/_inner/_lanczos_basis/
_tridiag_eigh``. The jitted ``fori_loop`` becomes a Python loop over
preallocated tensors; nothing in it reads a value back to the host.
"""

import torch


def _norm(v):
    return torch.sqrt(torch.sum(torch.abs(v) ** 2))


def _inner(a, b):
    return torch.sum(torch.conj(a) * b)


def _lanczos_basis(matvec, v0, ncv):
    """Build an ``ncv``-step Lanczos basis with full reorthogonalisation.

    Returns (V, alpha, beta): V (ncv, n) orthonormal, alpha (ncv,) real
    diagonal, beta (ncv,) off-diagonals (beta[ncv-1] is the residual
    norm). Works on vectors of any tensor shape (flattened internally).
    """
    shape = v0.shape
    n = v0.numel()
    v = torch.reshape(v0, (n,))
    v = v / _norm(v)
    V = torch.zeros((ncv, n), dtype=v.dtype, device=v.device)
    V[0] = v
    alpha = torch.zeros((ncv,), dtype=v.real.dtype, device=v.device)
    beta = torch.zeros((ncv,), dtype=v.real.dtype, device=v.device)
    for j in range(ncv):
        vj = V[j]
        w = torch.reshape(matvec(torch.reshape(vj, shape)), (n,))
        alpha[j] = _inner(vj, w).real
        # subtract the projections on all basis vectors built so far
        # (rows > j are zero), twice for robustness ("twice is enough")
        for _ in range(2):
            w = w - V.T @ (V.conj() @ w)
        b = _norm(w)
        beta[j] = b
        if j + 1 < ncv:
            V[j + 1] = torch.where(b > 1e-30, w / b, w)
    return V, alpha, beta


def _tridiag_eigh(alpha, beta):
    """Eigendecomposition of the symmetric tridiagonal (alpha, beta)."""
    m = alpha.shape[0]
    T = (
        torch.diag(alpha)
        + torch.diag(beta[: m - 1], 1)
        + torch.diag(beta[: m - 1], -1)
    )
    return torch.linalg.eigh(T)
