"""Dense and iterative eigensolving, matrix functions and norms.

Port of ``quimb_tpu/linalg/base_linalg.py``: ``eigensystem_partial`` with
its backends (``numpy``: a dense ``torch.linalg.eigh``; ``lanczos``:
restarted Lanczos with deflation; ``lobpcg``; ``scipy``: ARPACK on the
host), ``groundstate`` / ``groundenergy``, ``expm_multiply``, the full
``eigensystem`` and its forms (``eig``, ``eigh``, ``eigvalsh``, ...), the
spectral windows (``bound_spectrum``, ``eigh_window``), ``svd`` /
``svds``, the norms, ``expm``, ``sqrtm``, ``Lazy`` and
``IdentityLinearOperator``. An operator is a host scipy matrix, made a
device operator on ``device`` (the GPU unless the caller names another); a
:class:`~quimb_torch.core.SparseHam` or
:class:`~quimb_torch.core.LocalTermsHam`, on its own device; a dense
tensor or array; a :class:`Lazy` one, built when it is used; or an object
with ``shape``, ``dtype`` and ``@`` (such as
:class:`~quimb_torch.operator.configdevice.CoupledHam`), solved on its
``device`` when it has one.
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


class Lazy:
    """A lazily built operator: ``Lazy(fn, *args, shape=...)`` builds
    ``fn(*args, **kwargs)`` (times ``factor``) when it is called
    (reference ``Lazy`` base_linalg.py:632)."""

    def __init__(self, fn, *args, shape=None, factor=None, **kwargs):
        if shape is None:
            raise TypeError("`shape` must be specified.")
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.shape = shape
        self.factor = factor
        self.dtype = None

    def __call__(self, **kwargs):
        A = self.fn(*self.args, **self.kwargs, **kwargs)
        if self.factor is not None:
            A = self.factor * A
        return A

    def __repr__(self):
        return f"<Lazy({self.fn.__name__}, shape={self.shape})>"


def _as_operator(A, device=None):
    """Normalise an operator: returns (matvec, n, dtype, dense tensor or
    None, device). An operator that carries a ``device`` is applied
    there."""
    if isinstance(A, Lazy):
        A = A()
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
    own = getattr(A, "device", None)
    return (lambda x: A @ x), A.shape[0], A.dtype, None, \
        torch.device(own) if own is not None else resolve_device(device)


def choose_backend(A, k, int_eps=False, B=None):
    """The backend for ``k`` eigenpairs of ``A``: dense for a dense
    operator of fewer than :data:`AUTO_DENSE_CUTOFF` entries or an
    interior window, Lanczos otherwise. ``B`` (a generalised problem's
    metric) is ignored, as quimb_tpu ignores it."""
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


def eigensystem_partial(A, k, isherm=True, B=None, which=None,
                        return_vecs=True, sigma=None, ncv=None, tol=1e-10,
                        v0=None, sort=True, backend=None,
                        fallback_to_scipy=True, device=None, **backend_opts):
    """``k`` extremal eigenpairs of the hermitian operator ``A``
    (``which="SA"`` smallest, ``"LA"`` largest), or the ``k`` nearest
    ``sigma``. Returns the eigenvalues (k,) and, with ``return_vecs``, the
    vectors as columns (n, k), on the operator's device, sorted. ``B``,
    ``sort`` and ``fallback_to_scipy`` are accepted and ignored, as
    quimb_tpu ignores them."""
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
                 restarts=None, A=None):
    """Restarted Lanczos for ``k`` extremal eigenpairs, with deflation:
    the j-th solve shifts the pairs found so far out of the way and starts
    from standard normal draws of a CPU ``torch.Generator`` seeded ``j -
    1``, moved to the device (quimb_tpu draws them from
    ``jax.random.PRNGKey(j - 1)``, which torch cannot reproduce). Returns
    (lams (k,), vecs (k, n)) sorted. ``A``, the operator behind ``mv``,
    is ignored: quimb_tpu passes it to its compiled solve as an operand,
    and the port compiles nothing."""
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


def expm_multiply(mat, vec, backend="AUTO", ncv=None, device=None):
    """``expm(mat) @ vec`` without forming ``expm(mat)``, by Krylov
    projection: Arnoldi when the operator or the vector is complex (so
    ``-1j * H`` is exact), Lanczos otherwise. A complex vector is taken to
    complex128, or complex64 when it was float32 or complex64 (quimb_tpu
    keys this on its x64 flag instead). ``backend`` is ignored, as
    quimb_tpu ignores it: both always project on a Krylov space."""
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


# -- full eigensystems, windows, SVD, norms and matrix functions --------------


def _dense(A, device=None):
    """``A`` as a dense tensor: a tensor as it is, host data on ``device``
    (the GPU by default), a device operator by its ``to_dense``."""
    if isinstance(A, Lazy):
        A = A()
    if isinstance(A, torch.Tensor):
        return A
    if sp.issparse(A):
        A = A.toarray()
    elif hasattr(A, "to_dense"):
        return A.to_dense()
    return to_device(np.asarray(A), device=resolve_device(device))


def eigensystem(A, isherm=True, k=-1, sort=True, return_vecs=True,
                autoblock=False, device=None, **kwargs):
    """All eigenpairs of ``A`` (a dense ``eigh``, or ``eig`` for a
    non-hermitian ``A``), sorted by their real part; ``k`` of them by
    :func:`eigensystem_partial` when ``0 < k < n``; with ``autoblock``
    by :func:`~quimb_torch.linalg.autoblock.eigensystem_autoblocked`."""
    if autoblock:
        from .autoblock import eigensystem_autoblocked

        return eigensystem_autoblocked(A, sort=sort, isherm=isherm,
                                       return_vecs=return_vecs,
                                       device=device)
    if k == -1 or (isinstance(k, int) and k >= np.shape(A)[0]):
        A = _dense(A, device)
        if isherm:
            el, ev = torch.linalg.eigh(A)
        else:
            el, ev = torch.linalg.eig(A)
        if sort:
            order = torch.argsort(el.real)
            el, ev = el[order], ev[:, order]
        return (el, ev) if return_vecs else el
    return eigensystem_partial(A, k, isherm=isherm, return_vecs=return_vecs,
                               device=device, **kwargs)


def eig(A, k=-1, **kwargs):
    return eigensystem(A, isherm=False, k=k, **kwargs)


def eigh(A, k=-1, **kwargs):
    return eigensystem(A, isherm=True, k=k, **kwargs)


def eigvals(A, k=-1, **kwargs):
    return eigensystem(A, isherm=False, k=k, return_vecs=False, **kwargs)


def eigvalsh(A, k=-1, **kwargs):
    return eigensystem(A, isherm=True, k=k, return_vecs=False, **kwargs)


def eigenvectors(A, isherm=True, k=-1, **kwargs):
    return eigensystem(A, isherm=isherm, k=k, return_vecs=True, **kwargs)[1]


eigvecs = eigenvectors


def eigvecsh(A, k=-1, **kwargs):
    return eigenvectors(A, isherm=True, k=k, **kwargs)


def bound_spectrum(A, backend="auto", **kwargs):
    """(lmin, lmax) of the hermitian ``A``."""
    lmin = eigensystem_partial(A, k=1, which="SA", return_vecs=False,
                               backend=backend, **kwargs)[0]
    lmax = eigensystem_partial(A, k=1, which="LA", return_vecs=False,
                               backend=backend, **kwargs)[0]
    return lmin, lmax


def eigh_window(A, w_0, k, w_sz=None, backend="AUTO", return_vecs=True,
                offset_const=1 / 104, device=None, **kwargs):
    """The ``k`` eigenpairs nearest the relative position ``w_0`` in [0,
    1] of the spectrum (reference ``eigh_window`` base_linalg.py:282):
    by a dense ``eigh`` for a dense operator, a sparse one of at most
    :data:`AUTO_DENSE_CUTOFF` rows or ``backend="numpy"``; otherwise the
    spectrum's bounds by Lanczos, then the folded spectrum at the
    window's centre."""
    n = np.shape(A)[0]
    if _isdense(A) or (sp.issparse(A) and n <= AUTO_DENSE_CUTOFF) or \
            backend.lower() == "numpy":
        el, ev = torch.linalg.eigh(_dense(A, device))
        lmin, lmax = el[0], el[-1]
        wa = lmin + w_0 * (lmax - lmin)
        idx = torch.argsort(torch.abs(el - wa))[:k]
        idx = idx[torch.argsort(el[idx])]
        return (el[idx], ev[:, idx]) if return_vecs else el[idx]
    lmin, lmax = bound_spectrum(A, device=device, **kwargs)
    sigma = float(lmin + w_0 * (lmax - lmin))
    return eigensystem_partial(A, k, sigma=sigma, return_vecs=return_vecs,
                               device=device, **kwargs)


def eigvalsh_window(*args, **kwargs):
    return eigh_window(*args, return_vecs=False, **kwargs)


def eigvecsh_window(*args, **kwargs):
    return eigh_window(*args, return_vecs=True, **kwargs)[1]


def svd(A, return_vecs=True, device=None):
    """The thin SVD (U, s, VH) of ``A``, or its singular values."""
    A = _dense(A, device)
    if return_vecs:
        return torch.linalg.svd(A, full_matrices=False)
    return torch.linalg.svdvals(A)


def svds(A, k, ncv=None, return_vecs=True, backend="auto", device=None,
         **kwargs):
    """The ``k`` largest singular triples of ``A``, from its dense SVD as
    in quimb_tpu."""
    U, s, VH = svd(A, device=device)
    if return_vecs:
        return U[:, :k], s[:k], VH[:k]
    return s[:k]


def norm_fro(A):
    return torch.linalg.norm(A.reshape(-1))


def norm_trace(A, isherm=True):
    if isherm:
        return torch.sum(torch.abs(torch.linalg.eigvalsh(A)))
    return torch.sum(torch.linalg.svdvals(A))


def norm_2(A):
    return torch.linalg.svdvals(A)[0]


def norm(A, ntype=2, **kwargs):
    """The spectral (2), Frobenius ('fro') or trace ('tr', 'nuc') norm of
    the tensor ``A``."""
    types = {"2": "2", 2: "2", "spectral": "2", "f": "fro", "fro": "fro",
             "t": "tr", "trace": "tr", "tr": "tr", "nuc": "tr"}
    A = _dense(A)
    nt = types[ntype]
    if nt == "2":
        return norm_2(A)
    if nt == "fro":
        return norm_fro(A)
    return norm_trace(A, **kwargs)


def expm(A, herm=False, device=None):
    """The matrix exponential of ``A``: by ``eigh`` when ``herm``, else
    ``torch.linalg.matrix_exp`` (quimb_tpu's is JAX's Pade ``expm``)."""
    A = _dense(A, device)
    if herm:
        el, ev = torch.linalg.eigh(A)
        dt = torch.promote_types(ev.dtype, el.dtype)
        return (ev.to(dt) * torch.exp(el).to(dt)) @ ev.to(dt).conj().T
    return torch.linalg.matrix_exp(A)


def sqrtm(A, herm=True, device=None):
    """The matrix square root of ``A``: by ``eigh``, its negative
    eigenvalues clipped to zero, when ``herm``; else scipy's ``sqrtm`` on
    the host."""
    A = _dense(A, device)
    if herm:
        el, ev = torch.linalg.eigh(A)
        sq = torch.sqrt(torch.clip(el, min=0.0))
        dt = torch.promote_types(ev.dtype, sq.dtype)
        return (ev.to(dt) * sq.to(dt)) @ ev.to(dt).conj().T
    import scipy.linalg as sla

    return to_device(sla.sqrtm(to_host(A)), device=A.device)


class IdentityLinearOperator:
    """The identity (times ``factor``) as a lazy operator (reference
    ``IdentityLinearOperator``)."""

    def __init__(self, size, factor=1):
        self.shape = (size, size)
        self.factor = factor

    def matvec(self, x):
        return self.factor * x

    def __matmul__(self, x):
        return self.factor * x


__all__ = [
    "AUTO_DENSE_CUTOFF", "Lazy", "choose_backend", "eigensystem_partial",
    "eigsh_device", "groundstate", "groundenergy", "expm_multiply",
    "eigensystem", "eig", "eigh", "eigvals", "eigvalsh", "eigenvectors",
    "eigvecs", "eigvecsh", "bound_spectrum", "eigh_window",
    "eigvalsh_window", "eigvecsh_window", "svd", "svds", "norm_fro",
    "norm_trace", "norm_2", "norm", "expm", "sqrtm",
    "IdentityLinearOperator", "eigensystem_autoblocked", "compute_blocks",
]

from .autoblock import compute_blocks, eigensystem_autoblocked  # noqa: E402
