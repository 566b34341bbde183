"""Time evolution of a ket under a time-independent Hamiltonian, by Krylov
``exp(-i H dt) v``.

Port of ``quimb_tpu/evo.py``'s ``Evolution`` with ``method="expm"``: each
``update_to`` projects onto one Lanczos basis of the hermitian operator
(:func:`quimb_torch.linalg.lanczos.expm_multiply_krylov` with complex time)
or, for an operator given only by ``@``, onto an Arnoldi basis of ``x ->
-1j H x``. The ``integrate`` and ``solve`` methods come with ROADMAP queue 1,
item 16.
"""

import numpy as np
import scipy.sparse as sp
import torch

from .core import LocalTermsHam, SparseHam, device_operator, isop, quimbify
from .linalg.base_linalg import _dense_matvec
from .linalg.lanczos import expm_multiply_krylov
from .ops.backend import complex_dtype, resolve_device, to_device


def _matvec_of(ham, device):
    """``x -> H @ x`` on ``device``, a host operator made a device one."""
    if sp.issparse(ham):
        ham = device_operator(ham, device=device)
    elif isinstance(ham, (np.ndarray, torch.Tensor)):
        return _dense_matvec(to_device(ham, device=device))
    return lambda x: ham @ x


class Evolution:
    """Evolve a ket in time (reference ``Evolution`` evo.py:293).

    Parameters
    ----------
    p0 : ket
        The start state: a tensor stays on its device, host data goes to
        the GPU. It is taken to complex128, or to complex64 when it was
        float32 or complex64 (quimb_tpu keys this on its x64 flag instead).
    ham : operator
        A host scipy matrix (made a device operator on the state's device),
        a :class:`~quimb_torch.core.SparseHam` or
        :class:`~quimb_torch.core.LocalTermsHam`, a dense tensor or array,
        all taken as hermitian; or another object with ``@``, evolved by
        Arnoldi.
    t0 : float
        The start time.
    compute : callable or dict of callables
        ``f(t, pt)`` called after every update, its results gathered in
        ``.results``.
    method : {'expm'}
        'integrate' (quimb_tpu's default) and 'solve' are not ported yet.
    expm_opts : dict
        ``ncv``, the size of the Krylov basis (32).
    """

    #: results of the ``compute`` callback(s), if any
    results = None

    def __init__(self, p0, ham, t0=0, compute=None, method="integrate",
                 expm_opts=None):
        if method in ("integrate", "solve"):
            raise NotImplementedError(
                f"Evolution method {method!r} is not ported yet (ROADMAP "
                f"queue 1, item 16); use method='expm'")
        if method != "expm":
            raise ValueError(f"unknown method {method}")
        if callable(ham) and not hasattr(ham, "shape"):
            raise TypeError("expm method doesn't support time-dependent H")
        if not isinstance(p0, torch.Tensor):
            p0 = to_device(np.asarray(p0), device=resolve_device(None))
        self._p0 = quimbify(p0, dtype=complex_dtype(p0.dtype))
        if isop(self._p0):
            raise NotImplementedError("Evolution of a density operator is "
                                      "not ported yet (ROADMAP item 16)")
        self._t = self.t0 = t0
        self._expm_opts = dict(expm_opts or {})
        self._setup_callbacks(compute)

        # a hermitian operator: Lanczos with complex time; any other
        # operator: Arnoldi on x -> -1j H x
        mv = _matvec_of(ham, self._p0.device)
        self._hermitian = sp.issparse(ham) or isinstance(
            ham, (SparseHam, LocalTermsHam, torch.Tensor, np.ndarray))
        self._mv = mv if self._hermitian else (lambda x: -1j * mv(x))
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

    def _update_to_expm_ket(self, t):
        dt = t - self._t
        ncv = self._expm_opts.get("ncv", 32)
        v = torch.reshape(self._pt, (-1,))
        out = expm_multiply_krylov(
            self._mv, v, t=-1j * dt if self._hermitian else dt, ncv=ncv,
            hermitian=self._hermitian)
        self._pt = torch.reshape(out, self._pt.shape)
        self._t = t

    def update_to(self, t):
        """Update the state to time ``t``."""
        self._update_to_expm_ket(t)
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
