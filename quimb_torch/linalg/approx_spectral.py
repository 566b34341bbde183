"""Stochastic Lanczos quadrature: estimates of spectral sums ``Tr f(A)``
of operators known only through their products.

Port of quimb_tpu's ``linalg/approx_spectral.py`` (reference
``quimb/linalg/approx_spectral.py``: ``construct_lanczos_tridiag`` :234,
the lazy partial-trace operators :26-:80, ``approx_spectral_function``
:491, :696). quimb_tpu maps the Lanczos recurrence over its probes with
``vmap``; here each of the ``K`` steps multiplies the whole wave of
probes at once (the operator's ``matmat``), and no step reads the
device. The probes are numpy Rademacher draws from ``seed``, the same as
quimb_tpu's; each wave's Ritz values and weights are read to the host
once, where ``f`` is applied.
"""

import math

import numpy as np
import torch

from ..core import prod
from ..ops.backend import resolve_device

# -- lazy partial-trace operators ---------------------------------------------


def _as_device_tensor(psi, device):
    if isinstance(psi, torch.Tensor):
        return psi if device is None else psi.to(device)
    return torch.as_tensor(np.asarray(psi), device=resolve_device(device))


def _sys_tuple(sys):
    return (int(sys),) if isinstance(sys, (int, np.integer)) else tuple(sys)


class LazyPtrOperator:
    """rho_A of a pure state psi_AB, as a lazy operator (reference
    ``lazy_ptr_linop`` approx_spectral.py:26)."""

    def __init__(self, psi, dims, sysa, device=None):
        dims = tuple(dims)
        sysa = _sys_tuple(sysa)
        sysb = tuple(i for i in range(len(dims)) if i not in sysa)
        dA = prod(dims[i] for i in sysa)
        dB = prod(dims[i] for i in sysb)
        t = _as_device_tensor(psi, device).reshape(dims)
        self.Psi = t.permute(*sysa, *sysb).reshape(dA, dB)
        self.shape = (dA, dA)
        self.dtype = self.Psi.dtype

    def matvec(self, x):
        return self.Psi @ (self.Psi.conj().T @ x)

    matmat = matvec

    def __matmul__(self, x):
        return self.matvec(x)


class LazyPtrPptOperator:
    """(rho_AB)^{T_B} of a pure state psi_ABC, as a lazy operator
    (reference ``lazy_ptr_ppt_linop`` approx_spectral.py:80)."""

    def __init__(self, psi, dims, sysa, sysb, device=None):
        dims = tuple(dims)
        sysa, sysb = _sys_tuple(sysa), _sys_tuple(sysb)
        sysc = tuple(i for i in range(len(dims)) if i not in sysa + sysb)
        dA = prod(dims[i] for i in sysa)
        dB = prod(dims[i] for i in sysb)
        dC = prod(dims[i] for i in sysc) if sysc else 1
        t = _as_device_tensor(psi, device).reshape(dims)
        self.Psi = t.permute(*sysa, *sysb, *sysc).reshape(dA, dB, dC)
        self.dA, self.dB = dA, dB
        self.shape = (dA * dB, dA * dB)
        self.dtype = self.Psi.dtype

    def matvec(self, x):
        # y[a,b] = sum_{a'b'c} Psi[a,b',c] conj(Psi[a',b,c]) X[a',b']
        X = x.reshape(self.dA, self.dB)
        g = torch.einsum("abc,ad->bcd", self.Psi.conj(), X)
        return torch.einsum("adc,bcd->ab", self.Psi, g).reshape(-1)

    def matmat(self, X):
        k = X.shape[1]
        Xt = X.reshape(self.dA, self.dB, k)
        g = torch.einsum("abc,adk->bcdk", self.Psi.conj(), Xt)
        return torch.einsum("adc,bcdk->abk", self.Psi, g).reshape(-1, k)

    def __matmul__(self, x):
        return self.matvec(x)


# -- batched Lanczos tridiagonalization -----------------------------------------


def construct_lanczos_tridiag(matmat=None, n=None, K=None, V0=None,
                              dtype=None, matvec=None):
    """Lanczos on a wave of probes at once: ``V0`` (R, n) -> ``(alpha,
    beta)``, each (R, K). ``matmat`` maps an (n, R) block to (n, R); or
    ``matvec``, quimb_tpu's keyword, maps one (n,) vector and is applied
    to every probe by ``torch.func.vmap``, as quimb_tpu applies it by
    ``jax.vmap``.

    No reorthogonalization (quadrature tolerates the ghost eigenvalues, as
    the reference's loop does, approx_spectral.py:307-339); the ``K``
    steps run on the device with no read of it."""
    if (matmat is None) == (matvec is None):
        raise ValueError("give one of matmat and matvec")
    if matvec is not None:
        matmat = torch.func.vmap(matvec, in_dims=1, out_dims=1)
    v = V0 / torch.linalg.vector_norm(V0, dim=1, keepdim=True)
    vm = torch.zeros_like(v)
    b = torch.zeros(v.shape[0], dtype=v.real.dtype, device=v.device)
    alphas, betas = [], []
    for _ in range(K):
        w = matmat(v.T).T
        a = torch.sum(v.conj() * w, dim=1).real
        w = w - a[:, None] * v - b[:, None] * vm
        bnew = torch.linalg.vector_norm(w, dim=1)
        wn = torch.where(bnew[:, None] > 1e-30, w / bnew[:, None], w)
        alphas.append(a)
        betas.append(bnew)
        v, vm, b = wn, v, bnew
    return torch.stack(alphas, dim=1), torch.stack(betas, dim=1)


def _quadrature_weights(alpha, beta):
    """The Ritz values and quadrature weights tau^2 of each probe's
    tridiagonal matrix."""
    T = (torch.diag_embed(alpha) + torch.diag_embed(beta[:, :-1], 1)
         + torch.diag_embed(beta[:, :-1], -1))
    w, S = torch.linalg.eigh(T)
    return w, torch.abs(S[:, 0, :]) ** 2


def _operator_matmat(A):
    """``(matmat, n, dtype, device)`` of an operator or a dense matrix."""
    if hasattr(A, "matmat") or hasattr(A, "matvec"):
        fn = getattr(A, "matmat", None)
        if fn is None:
            def fn(X):
                return torch.stack([A.matvec(X[:, j])
                                    for j in range(X.shape[1])], dim=1)
        dev = getattr(A, "device", None)
        if dev is None:
            dev = A.Psi.device if hasattr(A, "Psi") else resolve_device(None)
        return fn, A.shape[0], A.dtype, dev
    Aa = A if isinstance(A, torch.Tensor) else _as_device_tensor(A, None)
    return (lambda X: Aa @ X), Aa.shape[0], Aa.dtype, Aa.device


def approx_spectral_function(A, f, tol=1e-2, *, bsz=1, R=1024, R_min=3,
                             tol_scale=1, tau=1e-4, k_min=10, k_max=512,
                             beta_tol=1e-6, mpi=False, mean_p=0.7,
                             mean_s=1.0, pos=False, v0=None, verbosity=0,
                             seed=None, plot=False, info=None,
                             **lanczos_opts):
    """Estimate ``Tr f(A)`` by stochastic Lanczos quadrature (reference
    ``approx_spectral_function`` approx_spectral.py:491), in waves of
    ``max(R_min, 8)`` probes until the standard error is below ``tol``
    times ``max(|mean|, tol_scale)``. ``info``, a dict, receives the
    probes used, the error and the scale."""
    mm, n, dtype, device = _operator_matmat(A)
    K = int(min(max(k_min, 2 * int(math.log2(n) ** 1.5)), k_max, n))
    rng = np.random.default_rng(seed)
    estimates = []
    total_R = 0
    wave = max(R_min, 8)
    m = err = scale = None
    while total_R < R:
        V0 = torch.as_tensor(rng.choice([-1.0, 1.0], size=(wave, n)),
                             device=device).to(dtype)
        alpha, beta = construct_lanczos_tridiag(mm, n, K, V0)
        w, tau2 = _quadrature_weights(alpha, beta)
        w_np = w.cpu().numpy()
        tau2_np = tau2.cpu().numpy()
        if pos:
            w_np = np.clip(w_np, 0.0, None)
        vals = f(w_np)
        vals = np.where(np.isfinite(vals), vals, 0.0)
        estimates.extend((n * np.sum(tau2_np * vals, axis=1)).tolist())
        total_R += wave
        if len(estimates) >= R_min:
            m = float(np.mean(estimates))
            err = float(np.std(estimates) / math.sqrt(len(estimates)))
            scale = max(abs(m), tol_scale)
            if verbosity:
                print(f"R={total_R} est={m} +- {err}")
            if err < tol * scale:
                break
    if info is not None:
        info.update(R=total_R, K=K, error=err, scale=scale)
    return float(np.mean(estimates))


# -- the spectral sums --------------------------------------------------------


def tr_abs_approx(A, **kwargs):
    return approx_spectral_function(A, np.abs, **kwargs)


def tr_exp_approx(A, **kwargs):
    return approx_spectral_function(A, np.exp, **kwargs)


def tr_sqrt_approx(A, **kwargs):
    return approx_spectral_function(
        A, lambda x: np.sqrt(np.clip(x, 0, None)), pos=True, **kwargs)


def _np_xlogx(x):
    xp = np.clip(x, 1e-300, None)
    return np.where(x > 0, x * np.log2(xp), 0.0)


def tr_xlogx_approx(A, **kwargs):
    return approx_spectral_function(A, _np_xlogx, pos=True, **kwargs)


def entropy_subsys_approx(psi_ab, dims, sysa, device=None, **kwargs):
    """The entropy of subsystem ``sysa`` of a pure state, by SLQ on the
    lazy rho_A."""
    return -tr_xlogx_approx(LazyPtrOperator(psi_ab, dims, sysa, device),
                            **kwargs)


def tr_sqrt_subsys_approx(psi_ab, dims, sysa, device=None, **kwargs):
    return tr_sqrt_approx(LazyPtrOperator(psi_ab, dims, sysa, device),
                          **kwargs)


def norm_ppt_subsys_approx(psi_abc, dims, sysa, sysb, device=None,
                           **kwargs):
    return tr_abs_approx(LazyPtrPptOperator(psi_abc, dims, sysa, sysb,
                                            device), **kwargs)


def logneg_subsys_approx(psi_abc, dims, sysa, sysb, **kwargs):
    """The logarithmic negativity between two subsystems of a pure
    state."""
    return max(0.0, math.log2(norm_ppt_subsys_approx(psi_abc, dims, sysa,
                                                     sysb, **kwargs)))


def negativity_subsys_approx(psi_abc, dims, sysa, sysb, **kwargs):
    nrm = norm_ppt_subsys_approx(psi_abc, dims, sysa, sysb, **kwargs)
    return max(0.0, (nrm - 1) / 2)


def xlogx(x):
    """``x log2(x)`` with ``0 log 0 = 0`` (reference ``xlogx``
    approx_spectral.py:951); a host array in gives a host array out, so
    that it can be the ``f`` of :func:`approx_spectral_function`."""
    if not isinstance(x, torch.Tensor):
        return _np_xlogx(np.asarray(x))
    pos = x > 0
    return torch.where(pos, x * torch.log2(torch.where(pos, x,
                                                       torch.ones_like(x))),
                       torch.zeros_like(x))


__all__ = [
    "xlogx",
    "LazyPtrOperator", "LazyPtrPptOperator", "construct_lanczos_tridiag",
    "approx_spectral_function", "tr_abs_approx", "tr_exp_approx",
    "tr_sqrt_approx", "tr_xlogx_approx", "entropy_subsys_approx",
    "tr_sqrt_subsys_approx", "norm_ppt_subsys_approx",
    "logneg_subsys_approx", "negativity_subsys_approx",
]
