"""Time evolution of kets and density operators: Schrodinger and Lindblad
dynamics.

Port of ``quimb_tpu/evo.py`` (reference ``quimb/evo.py``: ``Evolution``
:293, the right-hand sides :41-243). Three methods:

- ``'integrate'``: the adaptive Dormand-Prince RK45 of quimb_tpu, a plain
  torch function of the right-hand side (quimb_tpu jits it), with its step
  control on the host: every step reads the error norm back (counted in
  :attr:`Evolution.host_reads`). A time-dependent Hamiltonian (a callable
  ``t -> H``) takes quimb_tpu's fixed-step RK4. A tuple ``(H, ls, gamma)``
  integrates the Lindblad equation.
- ``'solve'``: one dense ``eigh``; each update is a phase rotation in the
  eigenbasis.
- ``'expm'``: Krylov ``exp(-i H dt) v`` of a ket (Lanczos with complex
  time for a hermitian operator, Arnoldi for one given only by ``@``).
  Density operators evolve by ``'integrate'`` or ``'solve'``.

The state stays on its device; host data goes to the GPU.
"""

import numpy as np
import scipy.sparse as sp
import torch

from .core import (LocalTermsHam, SparseHam, dag, device_operator, dop, isop,
                   quimbify)
from .linalg.base_linalg import _dense_matvec
from .linalg.lanczos import expm_multiply_krylov
from .ops.backend import complex_dtype, resolve_device, to_device
from .utils import continuous_progbar


def _as_dense(ham, device, dtype):
    """``ham`` as a dense tensor on ``device`` in ``dtype``."""
    if isinstance(ham, (SparseHam, LocalTermsHam)) or (
            hasattr(ham, "to_dense") and not isinstance(ham, torch.Tensor)):
        ham = ham.to_dense()
    elif sp.issparse(ham):
        ham = ham.toarray()
    return to_device(ham, device=device, dtype=dtype)


def _matvec_of(ham, device):
    """``x -> H @ x`` on ``device``, a host operator made a device one."""
    if sp.issparse(ham):
        ham = device_operator(ham, device=device)
    elif isinstance(ham, (np.ndarray, torch.Tensor)):
        return _dense_matvec(to_device(ham, device=device))
    return lambda x: ham @ x


# -- right-hand sides (reference evo.py:41-243) -------------------------------


def schrodinger_eq_ket(ham, device=None):
    """The right-hand side of d|psi>/dt = -i H |psi>."""
    mv = _matvec_of(ham, resolve_device(device) if not isinstance(
        ham, torch.Tensor) else ham.device)

    def rhs(psi, t=None):
        return -1j * mv(psi)

    return rhs


def schrodinger_eq_dop(ham, device=None, dtype=torch.complex128):
    """The right-hand side of d rho/dt = -i [H, rho], ``H`` dense."""
    Ha = _as_dense(ham, _device_of(ham, device), dtype)

    def rhs(rho, t=None):
        return -1j * (Ha @ rho - rho @ Ha)

    return rhs


def lindblad_eq(ham, ls, gamma, device=None, dtype=torch.complex128):
    """The right-hand side of the Lindblad master equation, ``H`` and the
    jump operators ``ls`` dense (reference ``lindblad_eq``)."""
    dev = _device_of(ham, device)
    Ha = _as_dense(ham, dev, dtype)
    ls = [_as_dense(L, dev, dtype) for L in ls]
    lds = [dag(L) for L in ls]
    ldls = [LD @ L for L, LD in zip(ls, lds)]

    def rhs(rho, t=None):
        out = -1j * (Ha @ rho - rho @ Ha)
        for L, LD, LDL in zip(ls, lds, ldls):
            out = out + gamma * (L @ rho @ LD - 0.5 * (LDL @ rho + rho @ LDL))
        return out

    return rhs


def _device_of(ham, device):
    if device is not None:
        return resolve_device(device)
    own = getattr(ham, "device", None)
    return torch.device(own) if own is not None else resolve_device(None)


# -- RK45 (Dormand-Prince) ----------------------------------------------------

_DP_A = np.array([
    [0, 0, 0, 0, 0, 0],
    [1 / 5, 0, 0, 0, 0, 0],
    [3 / 40, 9 / 40, 0, 0, 0, 0],
    [44 / 45, -56 / 15, 32 / 9, 0, 0, 0],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0],
])
_DP_B5 = np.array(
    [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0])
_DP_B4 = np.array([
    5179 / 57600, 0, 7571 / 16695, 393 / 640, -92097 / 339200,
    187 / 2100, 1 / 40,
])


def rk45_step(rhs, y, dt):
    """One Dormand-Prince step: (the 5th-order state, the 2-norm of its
    difference from the 4th-order one, a 0-d tensor on the device), with
    quimb_tpu's order of operations (``evo.py:112-160``). Seven
    right-hand sides."""
    k = [rhs(y)]
    for i in range(1, 6):
        yi = y
        for j in range(i):
            if _DP_A[i, j]:
                yi = yi + dt * _DP_A[i, j] * k[j]
        k.append(rhs(yi))
    y5 = y
    for j in range(6):
        if _DP_B5[j]:
            y5 = y5 + dt * _DP_B5[j] * k[j]
    k.append(rhs(y5))
    y4 = y
    for j in range(7):
        if _DP_B4[j]:
            y4 = y4 + dt * _DP_B4[j] * k[j]
    return y5, torch.linalg.norm((y5 - y4).reshape(-1))


class Evolution:
    """Evolve a ket or a density operator in time (reference
    ``Evolution`` evo.py:293).

    Parameters
    ----------
    p0 : ket or density operator
        The start state: a tensor stays on its device, host data goes to
        the GPU. It is taken to complex128, or to complex64 when it was
        float32 or complex64 (quimb_tpu keys this on its x64 flag instead).
    ham : operator, callable or tuple
        A host scipy matrix, a :class:`~quimb_torch.core.SparseHam` or
        :class:`~quimb_torch.core.LocalTermsHam`, a dense tensor or array,
        all taken as hermitian; another object with ``@`` (evolved by
        Arnoldi under ``'expm'``); a callable ``t -> H(t)`` for
        ``'integrate'``; or ``(H, ls, gamma)`` for the Lindblad equation
        with jump operators ``ls`` at rate ``gamma`` (``'integrate'``).
    t0 : float
        The start time.
    compute : callable or dict of callables
        ``f(t, pt)`` called after every update, its results gathered in
        ``.results``.
    int_stop : callable
        ``f(t, pt)``, checked after every accepted RK45 step: a true value
        stops the integration there.
    method : {'integrate', 'solve', 'expm'}
    expm_opts : dict
        ``ncv``, the size of the Krylov basis (32).
    progbar : bool
        Show a progress bar for each update.
    """

    #: results of the ``compute`` callback(s), if any
    results = None

    def __init__(self, p0, ham, t0=0, compute=None, int_stop=None,
                 method="integrate", int_small_step=False,
                 expm_backend="AUTO", expm_opts=None, progbar=False):
        if not isinstance(p0, torch.Tensor):
            p0 = to_device(np.asarray(p0), device=resolve_device(None))
        self._p0 = quimbify(p0, dtype=complex_dtype(p0.dtype))
        lindblad = isinstance(ham, (tuple, list))
        if lindblad and not isop(self._p0):
            self._p0 = dop(self._p0)
        self._t = self.t0 = t0
        self._method = method
        self._int_stop = int_stop
        self._progbar = progbar
        self._timedep = callable(ham) and not hasattr(ham, "shape") \
            and not hasattr(ham, "matvec")
        self._isdop = isop(self._p0)
        self._expm_opts = dict(expm_opts or {})
        self._setup_callbacks(compute)
        #: accepted and rejected RK45 steps, and the host reads of the
        #: step control, over the evolution so far
        self.steps = self.rejected = self.host_reads = 0

        self._ham = ham
        dev, dt = self._p0.device, self._p0.dtype
        if method == "solve":
            if lindblad or self._timedep:
                raise TypeError("solve needs a time-independent H")
            el, ev = torch.linalg.eigh(_as_dense(ham, dev, dt))
            self._evals, self._evecs = el, ev
            self._p0_ab = dag(ev) @ self._p0 @ ev if self._isdop \
                else dag(ev) @ self._p0
            self._update_method = self._update_to_solved
        elif method == "integrate":
            self._setup_integrator(lindblad)
        elif method == "expm":
            if self._timedep or lindblad or self._isdop:
                raise TypeError("expm method evolves a ket under a "
                                "time-independent H")
            mv = _matvec_of(ham, dev)
            self._hermitian = sp.issparse(ham) or isinstance(
                ham, (SparseHam, LocalTermsHam, torch.Tensor, np.ndarray))
            self._mv = mv if self._hermitian else (lambda x: -1j * mv(x))
            self._update_method = self._update_to_expm
        else:
            raise ValueError(f"unknown method {method}")
        self._pt = self._p0

    def _setup_callbacks(self, compute):
        if compute is None:
            self._computes = None
        elif callable(compute):
            self._computes = compute
            self.results = []
        else:
            self._computes = dict(compute)
            self.results = {k: [] for k in self._computes}

    def _do_compute(self):
        if self._computes is None:
            return
        if callable(self._computes):
            self.results.append(self._computes(self._t, self._pt))
        else:
            for k, f in self._computes.items():
                self.results[k].append(f(self._t, self._pt))

    def _setup_integrator(self, lindblad):
        ham, dev, dt = self._ham, self._p0.device, self._p0.dtype
        if lindblad:
            H, ls, gamma = ham
            self._rhs = lindblad_eq(H, ls, gamma, device=dev, dtype=dt)
        elif self._timedep:
            self._update_method = self._update_to_integrate_timedep
            return
        elif self._isdop:
            self._rhs = schrodinger_eq_dop(ham, device=dev, dtype=dt)
        else:
            mv = _matvec_of(ham, dev)
            self._rhs = lambda y: -1j * mv(y.reshape(-1)).reshape(y.shape)
        self._update_method = self._update_to_integrate

    # -- update methods -------------------------------------------------------

    def _update_to_solved(self, t):
        phases = torch.exp(-1j * (t - self.t0) * self._evals).to(
            self._evecs.dtype)
        ev = self._evecs
        if self._isdop:
            mid = phases[:, None] * self._p0_ab * torch.conj(phases)[None, :]
            self._pt = ev @ mid @ dag(ev)
        else:
            self._pt = ev @ (phases[:, None] * self._p0_ab)
        self._t = t

    def _update_to_expm(self, t):
        dt = t - self._t
        ncv = self._expm_opts.get("ncv", 32)
        out = expm_multiply_krylov(
            self._mv, self._pt.reshape(-1), t=-1j * dt if self._hermitian else dt, ncv=ncv,
            hermitian=self._hermitian)
        self._pt = out.reshape(self._pt.shape)
        self._t = t

    def _update_to_integrate(self, t, rtol=1e-8, atol=1e-10):
        """quimb_tpu's RK45 loop (``evo.py:329-358``): the first step a
        hundredth of the interval, each step's error norm read on the host
        and the next step scaled by 0.9 (tol / err)^(1/5), clipped to [0.2,
        5]."""
        y, tcur = self._pt, self._t
        direction = 1.0 if t >= tcur else -1.0
        dt = direction * max(abs(t - tcur) / 100, 1e-8)
        nrm = float(torch.linalg.norm(y.reshape(-1)))
        self.host_reads += 1
        while direction * (t - tcur) > 1e-13:
            if direction * (tcur + dt) > direction * t:
                dt = t - tcur
            ynew, err = rk45_step(self._rhs, y, dt)
            err = float(err)
            self.host_reads += 1
            tol = atol + rtol * nrm
            if err <= tol or abs(dt) < 1e-12:
                y, tcur = ynew, tcur + dt
                self.steps += 1
                if self._int_stop is not None:
                    self._pt, self._t = y, tcur
                    if self._int_stop(tcur, y):
                        break
            else:
                self.rejected += 1
            if err > 0:
                dt = dt * min(max(0.9 * (tol / err) ** 0.2, 0.2), 5.0)
            else:
                dt = dt * 5.0
        self._pt = y
        self._t = t if self._int_stop is None else tcur

    def _update_to_integrate_timedep(self, t):
        """quimb_tpu's fixed-step RK4 for a time-dependent H
        (``evo.py:360-378``): at least 100 steps, 100 a unit of time."""
        dev, dtype = self._p0.device, self._p0.dtype

        def rhs(y, ti):
            Ht = _as_dense(self._ham(ti), dev, dtype)
            return -1j * (Ht @ y - y @ Ht) if self._isdop else -1j * (Ht @ y)

        y, tcur = self._pt, self._t
        n_steps = max(100, int(abs(t - tcur) * 100))
        dt = (t - tcur) / n_steps
        for i in range(n_steps):
            ti = tcur + i * dt
            k1 = rhs(y, ti)
            k2 = rhs(y + dt / 2 * k1, ti + dt / 2)
            k3 = rhs(y + dt / 2 * k2, ti + dt / 2)
            k4 = rhs(y + dt * k3, ti + dt)
            y = y + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        self._pt = y
        self._t = t

    # -- public API -----------------------------------------------------------

    def update_to(self, t):
        """Update the state to time ``t``."""
        if self._progbar:
            pbar = continuous_progbar(self._t, t)
            self._update_method(t)
            pbar.cupdate(self._t)
            pbar.close()
        else:
            self._update_method(t)
        self._do_compute()

    def at_times(self, ts):
        """Generator yielding the state at each time in ``ts``."""
        for t in ts:
            self.update_to(t)
            yield self._pt

    @property
    def t(self):
        return self._t

    @property
    def pt(self):
        return self._pt


__all__ = ["Evolution", "lindblad_eq", "rk45_step", "schrodinger_eq_dop",
           "schrodinger_eq_ket"]
