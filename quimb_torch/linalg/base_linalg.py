"""Extremal eigenpairs and ``exp(A) v`` of the exact layer.

Port of the solver front end of ``quimb_tpu/linalg/base_linalg.py``:
``eigensystem_partial`` with its backends (``numpy``: a dense
``torch.linalg.eigh``; ``lanczos``: restarted Lanczos with deflation;
``lobpcg``; ``scipy``: ARPACK on the host), ``groundstate`` /
``groundenergy`` and ``expm_multiply``. An operator is a host scipy matrix,
made a device operator on ``device`` (the GPU unless the caller names
another); a :class:`~quimb_torch.core.SparseHam` or
:class:`~quimb_torch.core.LocalTermsHam`, on its own device; a dense tensor
or array; or an object with ``shape``, ``dtype`` and ``@``.
"""

import numpy as np
import scipy.sparse as sp
import torch

from ..core import (LocalTermsHam, SparseHam, _apply_dtype, device_operator,
                    prod)
from ..ops.backend import (complex_dtype, numpy_dtype, resolve_device,
                           to_device, to_host)
from .lanczos import eigh_lanczos, expm_multiply_krylov, lobpcg_block

AUTO_DENSE_CUTOFF = 2**13


def _isdense(A):
    return isinstance(A, (torch.Tensor, np.ndarray))


def _dense_matvec(A):
    """``x -> A @ x`` for the dense tensor ``A`` and a vector of any
    dtype, in the dtype of :func:`quimb_torch.core._apply_dtype`; ``A``'s
    cast to it is made once."""
    cast = {A.dtype: A}

    def mv(x):
        dt = _apply_dtype(A.dtype, x.dtype)
        if dt not in cast:
            cast[dt] = A.to(dt)
        return cast[dt] @ x.to(dt)

    return mv


def _as_operator(A, device=None):
    """Normalise an operator: returns (matvec, n, dtype, dense tensor or
    None, device)."""
    if sp.issparse(A):
        A = device_operator(A, device=device)
    if isinstance(A, (SparseHam, LocalTermsHam)):
        return A.matvec, A.shape[0], A.dtype, None, A.device
    if isinstance(A, np.ndarray):
        A = to_device(A, device=resolve_device(device))
    if isinstance(A, torch.Tensor):
        return _dense_matvec(A), A.shape[0], A.dtype, A, A.device
    if callable(A) and not hasattr(A, "shape"):
        raise ValueError("bare callables need a wrapper with .shape")
    return (lambda x: A @ x), A.shape[0], A.dtype, None, \
        resolve_device(device)


def choose_backend(A, k, int_eps=False):
    """The backend for ``k`` eigenpairs of ``A``: dense for a dense
    operator of fewer than :data:`AUTO_DENSE_CUTOFF` entries or an
    interior window, Lanczos otherwise."""
    if _isdense(A) and prod(np.shape(A)) < AUTO_DENSE_CUTOFF:
        return "numpy"
    if int_eps:
        return "numpy"
    return "lanczos"


def _start_vector(n, dtype, device, seed=42):
    """quimb_tpu's start: ``np.random.default_rng(seed)`` normal draws, in
    the operator's dtype."""
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(n),
                           dtype=dtype, device=device)


def eigensystem_partial(A, k, isherm=True, which=None, return_vecs=True,
                        sigma=None, ncv=None, tol=1e-10, v0=None,
                        backend=None, device=None, **backend_opts):
    """``k`` extremal eigenpairs of the hermitian operator ``A``
    (``which="SA"`` smallest, ``"LA"`` largest), or the ``k`` nearest
    ``sigma``. Returns the eigenvalues (k,) and, with ``return_vecs``, the
    vectors as columns (n, k), on the operator's device."""
    if not isherm:
        raise NotImplementedError(
            "partial non-hermitian eigensolve: use a dense eig")
    if which is None:
        which = "SA" if sigma is None else "TR"
    backend = backend or "auto"
    if backend == "auto":
        backend = choose_backend(A, k, int_eps=sigma is not None)

    if backend in ("numpy", "dense"):
        if isinstance(A, (SparseHam, LocalTermsHam)):
            Aa = A.to_dense()
        elif sp.issparse(A):
            Aa = to_device(A.toarray(), device=resolve_device(device))
        else:
            Aa = _as_operator(A, device)[3]
        return _eigs_dense_partial(Aa, k, which, return_vecs, sigma)

    if backend in ("scipy", "arpack"):
        import scipy.sparse.linalg as spla

        if sp.issparse(A):
            Ah, dev = A, resolve_device(device)
        else:
            mv, n, dtype, _, dev = _as_operator(A, device)
            Ah = spla.LinearOperator(
                shape=(n, n), dtype=numpy_dtype(dtype),
                matvec=lambda x: to_host(mv(to_device(x, device=dev))))
        lk, vk = spla.eigsh(
            Ah, k=k, which={"TR": "LM"}.get(which, which), sigma=sigma,
            ncv=ncv, tol=tol,
            v0=None if v0 is None else to_host(v0).reshape(-1))
        lk = torch.as_tensor(lk, device=dev)
        return (lk, torch.as_tensor(vk, device=dev)) if return_vecs else lk

    mv, n, dtype, _, dev = _as_operator(A, device)
    if v0 is None:
        v0 = _start_vector(n, dtype, dev)
    else:
        v0 = torch.reshape(to_device(v0, device=dev, dtype=dtype), (-1,))

    if sigma is not None:
        # folded spectrum: the smallest eigenpairs of (A - sigma)^2
        def mv2(x):
            y = mv(x) - sigma * x
            return mv(y) - sigma * y

        _, vecs = eigsh_device(mv2, v0, k, which="SA", ncv=ncv, tol=tol,
                               **backend_opts)
        # Rayleigh quotients on A itself
        lams = torch.stack([torch.vdot(v, mv(v)).real for v in vecs])
        order = torch.argsort(lams)
        lams, vecs = lams[order], vecs[order]
        return (lams, vecs.T) if return_vecs else lams

    if backend == "lobpcg":
        X0 = torch.stack([v0] + [
            _start_vector(n, dtype, dev, seed=i) for i in range(1, k)],
            dim=1)
        lams, X = lobpcg_block(mv, X0,
                               maxiter=backend_opts.get("maxiter", 60),
                               largest=which in ("LA", "LM", "LR"))
        return (lams, X) if return_vecs else lams

    lams, vecs = eigsh_device(mv, v0, k, which=which, ncv=ncv, tol=tol,
                              **backend_opts)
    return (lams, vecs.T) if return_vecs else lams


def eigsh_device(mv, v0, k=1, which="SA", ncv=None, tol=1e-10,
                 restarts=None):
    """Restarted Lanczos for ``k`` extremal eigenpairs, with deflation:
    the j-th solve shifts the pairs found so far out of the way and starts
    from standard normal draws of a CPU ``torch.Generator`` seeded ``j -
    1``, moved to the device (quimb_tpu draws them from
    ``jax.random.PRNGKey(j - 1)``, which torch cannot reproduce). Returns
    (lams (k,), vecs (k, n)) sorted."""
    if ncv is None:
        ncv = max(20, 2 * k + 10)
    if restarts is None:
        restarts = 60
    which_l = "SA" if which in ("SA", "SR", "SM") else "LA"
    lams, vecs, v = [], [], v0
    for j in range(k):
        if j == 0:
            lam, vj = eigh_lanczos(mv, v, ncv=ncv, restarts=restarts,
                                   tol=tol, which=which_l)
        else:
            sign = 1.0 if which_l == "SA" else -1.0
            shifts = [sign * 1e3 * (1 + abs(float(lam_i))) for lam_i in lams]

            def mv_defl(x, found=tuple(zip(shifts, vecs))):
                y = mv(x)
                for shift, v_i in found:
                    y = y + shift * v_i * torch.vdot(v_i, x)
                return y

            _, vj = eigh_lanczos(mv_defl, v, ncv=ncv, restarts=restarts,
                                 tol=tol, which=which_l)
            # the eigenvalue on the operator itself
            lam = torch.vdot(vj, mv(vj)).real
        lams.append(lam)
        vecs.append(vj)
        if j + 1 < k:
            gen = torch.Generator().manual_seed(j)
            v = torch.randn(v0.shape, generator=gen, dtype=v0.real.dtype
                            ).to(device=v0.device, dtype=v0.dtype)
    lams, vecs = torch.stack(lams), torch.stack(vecs)
    order = torch.argsort(lams if which_l == "SA" else -lams)
    return lams[order], vecs[order]


def _eigs_dense_partial(Aa, k, which, return_vecs, sigma):
    el, ev = torch.linalg.eigh(Aa)
    if sigma is not None:
        idx = torch.argsort(torch.abs(el - sigma))[:k]
        idx = idx[torch.argsort(el[idx])]
    elif which in ("LA", "LM", "LR"):
        idx = torch.arange(Aa.shape[0] - k, Aa.shape[0], device=el.device)
    else:
        idx = torch.arange(k, device=el.device)
    return (el[idx], ev[:, idx]) if return_vecs else el[idx]


def groundstate(ham, **kwargs):
    """The ground state ket (n, 1) of ``ham``."""
    _, v = eigensystem_partial(ham, k=1, which="SA", return_vecs=True,
                               **kwargs)
    return torch.reshape(v, (-1, 1))


def groundenergy(ham, **kwargs):
    """The ground-state energy of ``ham``, a 0-d tensor on its device."""
    (lam,) = eigensystem_partial(ham, k=1, which="SA", return_vecs=False,
                                 **kwargs)
    return lam


def expm_multiply(mat, vec, ncv=None, device=None):
    """``expm(mat) @ vec`` without forming ``expm(mat)``, by Krylov
    projection: Arnoldi when the operator or the vector is complex (so
    ``-1j * H`` is exact), Lanczos otherwise. A complex vector is taken to
    complex128, or complex64 when it was float32 or complex64 (quimb_tpu
    keys this on its x64 flag instead)."""
    mv, n, dtype, _, dev = _as_operator(mat, device)
    v = torch.reshape(to_device(vec, device=dev), (-1,))
    if ncv is None:
        ncv = min(40, n)
    if dtype.is_complex or v.is_complex():
        out = expm_multiply_krylov(mv, v.to(complex_dtype(v.dtype)), t=1.0,
                                   ncv=ncv, hermitian=False)
    else:
        out = expm_multiply_krylov(mv, v, t=1.0, ncv=ncv, hermitian=True)
    return torch.reshape(out, np.shape(vec))
