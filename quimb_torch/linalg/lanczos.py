"""Lanczos with full reorthogonalisation, and the Krylov solvers built on it.

Port of ``quimb_tpu/linalg/lanczos.py``: the basis of the DMRG local solve
(``_lanczos_basis``, ``_tridiag_eigh``) and the solvers of the exact layer:
restarted Lanczos for an extremal eigenpair (``eigh_lanczos``, ``eigsh``),
``exp(t A) v`` by Krylov projection (``expm_multiply_krylov``) and blocked
LOBPCG (``lobpcg_block``). The jitted loops become Python loops over
preallocated tensors, and a basis build reads nothing back to the host.
The restarted solvers take quimb_tpu's host-restart form: one basis per
restart, its tridiagonal solved in float64 by LAPACK on the host (one read
of alpha and beta), and an early exit on the Ritz value. quimb_tpu's fused
``lax.scan`` of restarts exists to cut XLA dispatches and has no use here.

An operator ``A`` is a matvec callable, or an object with ``@`` on the
vectors' device: a tensor, :class:`quimb_torch.core.SparseHam` or
:class:`quimb_torch.core.LocalTermsHam`.
"""

import numpy as np
import scipy.linalg as sla
import torch


def _norm(v):
    return torch.sqrt(torch.sum(torch.abs(v) ** 2))


def _inner(a, b):
    return torch.sum(torch.conj(a) * b)


def _identity_like_matvec(A):
    """An operator spec -> a matvec closure: a callable as it is, else
    ``A @ x``."""
    if callable(A):
        return A
    return lambda x: A @ x


def _lanczos_basis(matvec, v0, ncv):
    """Build an ``ncv``-step Lanczos basis with full reorthogonalisation.

    Returns (V, alpha, beta): V (ncv, n) orthonormal, alpha (ncv,) real
    diagonal, beta (ncv,) off-diagonals (beta[ncv-1] is the residual
    norm). Works on vectors of any tensor shape (flattened internally).
    Where beta falls to 1e-30 the next row is left unnormalised, as in
    quimb_tpu: a basis longer than the start's Krylov space fills with
    rounding noise, and the Ritz values of that noise depend on the
    rounding of every step (DMRG1's tests hold this loop to quimb_tpu's
    operations, zero rows included).
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
        # (rows > j are zero), twice for robustness ("twice is enough");
        # conj(V) @ w as conj(V @ conj(w)), which conjugates a vector and
        # not the basis (a no-op for real tensors)
        for _ in range(2):
            w = w - V.T @ torch.conj(V @ torch.conj(w))
        b = _norm(w)
        beta[j] = b
        if j + 1 < ncv:
            V[j + 1] = torch.where(b > 1e-30, w / b, w)
    return V, alpha, beta


def _tridiag_eigh(alpha, beta):
    """Eigendecomposition of the symmetric tridiagonal (alpha, beta), on
    their device."""
    m = alpha.shape[0]
    T = (
        torch.diag(alpha)
        + torch.diag(beta[: m - 1], 1)
        + torch.diag(beta[: m - 1], -1)
    )
    return torch.linalg.eigh(T)


def _host_tridiag_eigh(alpha, beta):
    """LAPACK float64 eigendecomposition of the tridiagonal (alpha, beta),
    read from their device in one copy. Returns numpy (w ascending, S)."""
    ab = torch.stack([alpha, beta]).to("cpu", torch.float64).numpy()
    a, b = ab[0], ab[1, :-1]
    try:
        return sla.eigh_tridiagonal(a, b)
    except sla.LinAlgError:
        return np.linalg.eigh(np.diag(a) + np.diag(b, 1) + np.diag(b, -1))


def _ritz_vector(V, alpha, S, idx):
    """The normalised Ritz vector ``S[:, idx] @ V``, on V's device."""
    coeff = torch.as_tensor(S[:, idx], dtype=alpha.dtype, device=V.device)
    vec = coeff.to(V.dtype) @ V
    return vec / _norm(vec)


def eigh_lanczos(A, v0, ncv=20, restarts=4, tol=1e-9, which="SA"):
    """Extremal eigenpair of the hermitian operator ``A``: the smallest
    (``which="SA"``) or largest eigenvalue.

    Restarted Lanczos: each restart builds a fresh ``ncv``-vector basis
    from the current Ritz vector and solves its tridiagonal on the host in
    float64; the loop stops once the Ritz value moves by at most
    ``tol * max(1, |lam|)`` between restarts. Returns ``(eigenvalue,
    eigenvector)``: a 0-d tensor in the vectors' real dtype and a
    normalised vector shaped like ``v0``, both on ``v0``'s device.
    """
    matvec = _identity_like_matvec(A)
    idx = 0 if which in ("SA", "SR") else ncv - 1
    lam_prev, v = None, v0
    for _ in range(max(restarts, 1)):
        V, alpha, beta = _lanczos_basis(matvec, v, ncv)
        w, S = _host_tridiag_eigh(alpha, beta)
        lam = float(w[idx])
        v = torch.reshape(_ritz_vector(V, alpha, S, idx), v0.shape)
        if lam_prev is not None and \
                abs(lam - lam_prev) <= tol * max(1.0, abs(lam)):
            break
        lam_prev = lam
    return torch.tensor(lam, dtype=alpha.dtype, device=v0.device), v


def eigsh(A, k=1, v0=None, ncv=None, restarts=10, tol=1e-9, which="SA"):
    """``k`` extremal eigenpairs: for k=1 :func:`eigh_lanczos`; for k > 1
    the Ritz pairs of one enlarged Lanczos basis. Returns (lams (k,),
    vecs (k, *v0.shape))."""
    if v0 is None:
        raise ValueError("v0 required (provides shape/dtype)")
    if ncv is None:
        ncv = max(4 * k + 4, 20)
    if k == 1:
        lam, v = eigh_lanczos(A, v0, ncv=ncv, restarts=restarts, tol=tol,
                              which=which)
        return torch.reshape(lam, (1,)), torch.reshape(v, (1, *v0.shape))
    V, alpha, beta = _lanczos_basis(_identity_like_matvec(A), v0, ncv)
    w, S = _host_tridiag_eigh(alpha, beta)
    idx = list(range(k)) if which in ("SA", "SR") else \
        [ncv - 1 - i for i in range(k)]
    lams = torch.as_tensor(w[idx], dtype=alpha.dtype, device=V.device)
    vecs = torch.stack([_ritz_vector(V, alpha, S, i).reshape(v0.shape)
                        for i in idx])
    return lams, vecs


def _krylov_expm_recombine(V, w, S, t, nrm):
    """``exp(t T) e0 |v|`` mapped back through the basis ``V``, for the
    tridiagonal ``T = S diag(w) S^T`` (host numpy) and a host scalar
    ``t``, real or complex."""
    rdt = V.real.dtype
    w = torch.as_tensor(w, dtype=rdt, device=V.device)
    S = torch.as_tensor(S, dtype=rdt, device=V.device)
    phases = torch.exp(t * w)
    out_dtype = torch.promote_types(V.dtype, phases.dtype)
    small = S.to(out_dtype) @ (phases.to(out_dtype) * S[0, :].to(out_dtype))
    return (small @ V.to(out_dtype)) * nrm.to(rdt)


def expm_multiply_krylov(A, v, t=1.0, ncv=30, hermitian=True):
    """``exp(t A) @ v`` by Krylov projection onto ``ncv`` vectors, ``t`` a
    host scalar, real or complex.

    For hermitian ``A`` it builds one Lanczos basis, solves its
    tridiagonal on the host and maps ``exp(t T) e0`` back
    (:func:`_krylov_expm_recombine`); otherwise (a bare callable such as
    ``x -> -1j H x``) it builds an Arnoldi basis with two
    orthogonalisation passes and takes the ``expm`` of the small
    Hessenberg matrix on the device.
    """
    matvec = _identity_like_matvec(A)
    shape = v.shape
    n = v.numel()
    vf = torch.reshape(v, (n,))
    nrm = _norm(vf)
    if hermitian:
        V, alpha, beta = _lanczos_basis(matvec, v, ncv)
        w, S = _host_tridiag_eigh(alpha, beta)
        return torch.reshape(_krylov_expm_recombine(V, w, S, t, nrm), shape)

    V = torch.zeros((ncv, n), dtype=vf.dtype, device=vf.device)
    V[0] = vf / nrm
    H = torch.zeros((ncv + 1, ncv), dtype=vf.dtype, device=vf.device)
    for j in range(ncv):
        w = torch.reshape(matvec(torch.reshape(V[j], shape)), (n,))
        Vj = V[: j + 1]
        h = torch.conj(Vj @ torch.conj(w))
        w = w - Vj.T @ h
        h2 = torch.conj(Vj @ torch.conj(w))
        w = w - Vj.T @ h2
        H[: j + 1, j] = h + h2
        b = _norm(w)
        H[j + 1, j] = b
        if j + 1 < ncv:
            V[j + 1] = torch.where(b > 1e-30, w / b, w)
    eH = torch.linalg.matrix_exp(t * H[:ncv, :ncv])
    return torch.reshape((eH[:, 0] * nrm) @ V, shape)


def lobpcg_block(A, X0, maxiter=50, tol=1e-8, largest=False):
    """LOBPCG for the k smallest (or largest) eigenpairs of a hermitian
    operator, from the block ``X0`` (n, k): a fixed count of iterations,
    each a Rayleigh-Ritz step in the orthonormalised span of the block,
    its residuals and its last update. Returns (eigenvalues (k,),
    vectors (n, k)). ``tol`` is accepted and ignored, as quimb_tpu's fixed
    count of iterations ignores it."""
    matvec = _identity_like_matvec(A)
    n, k = X0.shape

    def mv_block(X):
        return torch.stack([torch.reshape(matvec(X[:, i]), (n,))
                            for i in range(X.shape[1])], dim=1)

    X = torch.linalg.qr(X0)[0]
    AX = mv_block(X)
    mu = torch.einsum("ij,ij->j", X.conj(), AX).real
    R = AX - X * mu
    P = torch.zeros_like(X)
    for _ in range(maxiter):
        S = torch.linalg.qr(torch.cat([X, R, P], dim=1))[0]
        AS = mv_block(S)
        G = S.conj().T @ AS
        G = (G + G.conj().T) / 2
        w, C = torch.linalg.eigh(G)
        m = G.shape[0]
        idx = torch.arange(m - 1, m - 1 - k, -1) if largest \
            else torch.arange(k)
        Ck = C[:, idx.to(C.device)]
        Xn, AXn, mu = S @ Ck, AS @ Ck, w[idx.to(w.device)]
        R = AXn - Xn * mu
        P = Xn - X @ (X.conj().T @ Xn)
        X = Xn
    return mu, X
