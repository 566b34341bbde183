"""Quantities of quantum states: entropies, entanglement measures,
fidelities, measurement and decompositions.

Port of ``quimb_tpu/calc.py`` (reference ``quimb/calc.py``: fidelity :53,
measure :246, simulate_counts :328, entropy :423, mutinf :486, logneg
:751, concurrence :879, quantum_discord :951, the decompositions and
correlations). The spectral work runs on the device of the state (a
dense ``eigh`` / ``eigvalsh``); measurement draws from
``np.random.default_rng(seed)`` on the host over probabilities computed on
the device, as quimb_tpu draws them; the quantum discord drives scipy's
COBYLA on the host. A large subsystem's entropy, negativity or trace
norm goes to the stochastic Lanczos estimates of
:mod:`quimb_torch.linalg.approx_spectral` at ``approx_thresh``, as in
quimb_tpu. Scalars come back as Python floats where quimb_tpu returns
floats, else as 0-d tensors.
"""

import collections
import functools
import itertools
import math
import numbers

import numpy as np
import torch

from .core import (dag, dop, expectation, ikron, infer_size, isket, isop,
                   isvec, prod, ptr)
from .linalg.base_linalg import norm, norm_2, sqrtm
from .ops.backend import to_device, to_host


def _pauli_np(s):
    from .gen.operators import _pauli

    return _pauli(s)


def _flat(p):
    return p.reshape(-1)


def fidelity(p1, p2, squared=False):
    """The fidelity of two states, kets or density operators (reference
    calc.py:53)."""
    if isvec(p1) or isvec(p2):
        if isvec(p1) and isvec(p2):
            F2 = torch.abs(torch.vdot(_flat(p1), _flat(p2))) ** 2
            return F2 if squared else torch.sqrt(F2)
        k, r = (p1, p2) if isvec(p1) else (p2, p1)
        k = k.reshape(-1, 1).to(r.dtype)
        F2 = torch.real((dag(k) @ r @ k)[0, 0])
        return F2 if squared else torch.sqrt(F2)
    sp1 = sqrtm(p1)
    F = torch.real(torch.trace(sqrtm(sp1 @ p2 @ sp1)))
    return F**2 if squared else F


def purify(rho):
    """A ket on the doubled space whose reduced state is ``rho``."""
    el, ev = torch.linalg.eigh(rho)
    el = torch.clip(el.real, min=0.0)
    return (ev * torch.sqrt(el)).to(rho.dtype).reshape(-1, 1)


def dephase(rho, p, rand_rank=None):
    """``rho`` dephased by the amount ``p``."""
    rho = dop(rho)
    return (1 - p) * rho + p * torch.diag(torch.diag(rho))


def kraus_op(rho, Ek, dims=None, where=None, check=False):
    """The Kraus channel sum_k E_k rho E_k^dagger; with ``where`` the
    operators act on those subsystems of ``dims``."""
    rho = dop(rho)
    Ek = to_device(Ek, device=rho.device, dtype=rho.dtype)
    if Ek.ndim == 2:
        Ek = Ek[None]
    if where is not None:
        Ek = torch.stack([ikron(E, tuple(dims), where) for E in Ek])
    return torch.einsum("kab,bc,kdc->ad", Ek, rho, torch.conj(Ek))


def projector(A, eigenvalue=1.0, tol=1e-12, autoblock=False):
    """The projector onto the ``eigenvalue`` eigenspace of the hermitian
    ``A``."""
    el, ev = torch.linalg.eigh(A)
    mask = (torch.abs(el - eigenvalue) < tol).to(ev.dtype)
    return (ev * mask) @ dag(ev)


def _groups(el, tol):
    """The eigenvalues' groups of (nearly) degenerate values."""
    groups = []
    for i, lam in enumerate(to_host(el)):
        if groups and abs(groups[-1][0] - lam) < tol:
            groups[-1][1].append(i)
        else:
            groups.append((lam, [i]))
    return groups


def measure(p, A, eigenvalue=None, tol=1e-12, seed=None):
    """Measure the state ``p`` with the hermitian ``A``: (the eigenvalue,
    the state after), the outcome drawn from
    ``np.random.default_rng(seed)`` unless ``eigenvalue`` is given
    (reference ``measure`` calc.py:246)."""
    el, ev = torch.linalg.eigh(A)
    groups = _groups(el, tol)
    if eigenvalue is None:
        pick = lambda probs: np.random.default_rng(seed).choice(  # noqa
            len(groups), p=probs)
    else:
        pick = lambda probs: int(np.argmin(  # noqa: E731
            [abs(g[0] - eigenvalue) for g in groups]))
    if isket(p):
        amps = dag(ev) @ p.to(ev.dtype)
        pr = to_host(torch.abs(amps[:, 0]) ** 2)
        probs = np.array([pr[idx].sum() for _, idx in groups])
        gi = pick(probs / probs.sum())
        lam, idx = groups[gi]
        mask = torch.zeros(el.shape[0], dtype=ev.dtype, device=ev.device)
        mask[idx] = 1.0
        p_after = ev @ (amps * mask[:, None])
        return lam, p_after / torch.linalg.norm(p_after)
    rho = p.to(ev.dtype)
    probs = np.array([
        float(torch.real(torch.einsum("ai,ab,bi->", torch.conj(ev[:, idx]),
                                      rho, ev[:, idx])))
        for _, idx in groups])
    probs = np.clip(probs, 0, None)
    probs = probs / probs.sum()
    gi = pick(probs)
    lam, idx = groups[gi]
    P = ev[:, idx] @ dag(ev[:, idx])
    return lam, P @ rho @ P / probs[gi]


def simulate_counts(p, C, phys_dim=2, seed=None):
    """``C`` measurements of ``p`` in the computational basis as a dict of
    counts, drawn from ``np.random.default_rng(seed)`` (reference
    ``simulate_counts`` calc.py:328)."""
    if isket(p):
        pr = torch.abs(p[:, 0]) ** 2
    elif isop(p):
        pr = torch.real(torch.diag(p))
    else:
        pr = torch.abs(_flat(p)) ** 2
    pr = np.clip(to_host(pr), 0, None)
    pr = pr / pr.sum()
    n = int(round(math.log(pr.size, phys_dim)))
    counts = {}
    for s in np.random.default_rng(seed).choice(pr.size, size=C, p=pr):
        b = np.base_repr(s, phys_dim).zfill(n)
        counts[b] = counts.get(b, 0) + 1
    return counts


def entropy(a, rank=None):
    """The von Neumann entropy in bits of a density operator, or of a
    vector of its eigenvalues (reference ``entropy`` calc.py:423)."""
    if a.ndim == 1 or (a.ndim == 2 and 1 in a.shape):
        el = _flat(a).real
    else:
        el = torch.linalg.eigvalsh(a)
    el = torch.clip(el, min=0.0)
    el_safe = torch.where(el > 1e-300, el, torch.ones_like(el))
    return float(-torch.sum(el * torch.log2(el_safe)))


def entropy_subsys(psi_ab, dims, sysa, approx_thresh=2**13, **approx_opts):
    """The entropy of the subsystems ``sysa`` of a pure state: of the
    smaller side's reduced state, exact below ``approx_thresh``, else by
    stochastic Lanczos quadrature."""
    if isinstance(sysa, numbers.Integral):
        sysa = (sysa,)
    sz_a = prod(dims[i] for i in sysa)
    sz_b = prod(dims) // sz_a
    if sz_a > sz_b:
        # the complement: the same entropy for a pure state
        sysa = tuple(i for i in range(len(dims)) if i not in sysa)
        sz_a = sz_b
    if approx_thresh is not None and sz_a >= approx_thresh:
        from .linalg.approx_spectral import entropy_subsys_approx

        return entropy_subsys_approx(psi_ab, dims, sysa, **approx_opts)
    return entropy(ptr(psi_ab, dims, sysa))


def mutinf(p, dims=(2, 2), sysa=0, rank=None):
    """The mutual information I(A:B) of ``sysa`` and the rest (reference
    ``mutinf`` calc.py:486)."""
    if isinstance(sysa, numbers.Integral):
        sysa = (sysa,)
    sysb = tuple(i for i in range(len(dims)) if i not in sysa)
    hab = 0.0 if isvec(p) else entropy(p)
    return entropy(ptr(p, dims, sysa)) + entropy(ptr(p, dims, sysb)) - hab


mutual_information = mutinf


def mutinf_subsys(psi_abc, dims, sysa, sysb, approx_thresh=2**13,
                  **approx_opts):
    """The mutual information of two subsystems of a pure state."""
    if isinstance(sysa, numbers.Integral):
        sysa = (sysa,)
    if isinstance(sysb, numbers.Integral):
        sysb = (sysb,)
    sysab = tuple(sorted((*sysa, *sysb)))
    ha, hb, hab = (entropy_subsys(psi_abc, dims, s, approx_thresh,
                                  **approx_opts)
                   for s in (sysa, sysb, sysab))
    return ha + hb - hab


def schmidt_gap(psi_ab, dims, sysa):
    """The difference of the two largest eigenvalues of the reduced
    state of ``sysa``."""
    el = torch.linalg.eigvalsh(ptr(psi_ab, dims, sysa))
    return float(el[-1] - el[-2])


def tr_sqrt(A, rank=None):
    """The trace of the square root of the positive ``A``."""
    el = torch.linalg.eigvalsh(A)
    return float(torch.sum(torch.sqrt(torch.clip(el, min=0.0))))


def tr_sqrt_subsys(psi_ab, dims, sysa, approx_thresh=2**13, **approx_opts):
    if isinstance(sysa, numbers.Integral):
        sysa = (sysa,)
    if approx_thresh is not None and prod(dims[i] for i in sysa) >= \
            approx_thresh:
        from .linalg.approx_spectral import tr_sqrt_subsys_approx

        return tr_sqrt_subsys_approx(psi_ab, dims, sysa, **approx_opts)
    return tr_sqrt(ptr(psi_ab, dims, sysa))


def partial_transpose(p, dims=(2, 2), sysa=0):
    """The partial transpose of ``p`` over the subsystems ``sysa``; runs of
    neighbouring subsystems are merged first."""
    from .core import dim_compress

    if isinstance(sysa, numbers.Integral):
        sysa = (sysa,)
    p = dop(p)
    dims, sysa = dim_compress(tuple(dims), sysa)
    n = len(dims)
    perm = [(i + n if i in sysa else i) for i in range(n)] + \
        [(i - n if (i - n) in sysa else i) for i in range(n, 2 * n)]
    d = prod(dims)
    return p.reshape(dims + dims).permute(perm).reshape(d, d)


def partial_transpose_norm(p, dims=(2, 2), sysa=0):
    """The trace norm of the partial transpose."""
    return float(norm(partial_transpose(p, dims, sysa), "tr"))


def logneg(p, dims=(2, 2), sysa=0):
    """The logarithmic negativity (reference ``logneg`` calc.py:751)."""
    return max(0.0, math.log2(partial_transpose_norm(p, dims, sysa)))


logarithmic_negativity = logneg


def logneg_subsys(psi_abc, dims, sysa, sysb, approx_thresh=2**13,
                  **approx_opts):
    """The logarithmic negativity of two subsystems of a pure state."""
    if isinstance(sysa, numbers.Integral):
        sysa = (sysa,)
    if isinstance(sysb, numbers.Integral):
        sysb = (sysb,)
    sysab = tuple(sorted((*sysa, *sysb)))
    if approx_thresh is not None and prod(dims[i] for i in sysab) >= \
            approx_thresh:
        from .linalg.approx_spectral import logneg_subsys_approx

        return logneg_subsys_approx(psi_abc, dims, sysa, sysb, **approx_opts)
    rho_ab = ptr(psi_abc, dims, sysab)
    return logneg(rho_ab, tuple(dims[i] for i in sysab),
                  tuple(sysab.index(i) for i in sysa))


def negativity(p, dims=(2, 2), sysa=0):
    """The negativity (reference ``negativity``)."""
    return max(0.0, (partial_transpose_norm(p, dims, sysa) - 1) / 2)


def concurrence(p, dims=(2, 2), sysa=0, sysb=1):
    """The concurrence of a two-qubit state (reference ``concurrence``
    calc.py:879)."""
    dev = p.device
    if isvec(p):
        k = p.reshape(-1, 1)
        YY = to_device(np.kron(_pauli_np("Y"), _pauli_np("Y")), device=dev,
                       dtype=torch.promote_types(k.dtype, torch.complex64))
        return float(torch.abs(k.to(YY.dtype).T @ YY @ k.to(YY.dtype))[0, 0])
    rho = dop(p)
    rho = rho.to(torch.promote_types(rho.dtype, torch.complex64))
    YY = to_device(np.kron(_pauli_np("Y"), _pauli_np("Y")), device=dev,
                   dtype=rho.dtype)
    el = torch.linalg.eigvals(rho @ (YY @ torch.conj(rho) @ YY))
    sqel = np.sqrt(np.clip(np.sort(to_host(el).real), 0, None))[::-1]
    return float(max(0.0, sqel[0] - sqel[1] - sqel[2] - sqel[3]))


def one_way_classical_information(p_ab, prjs, precomp_func=False):
    """The one-way classical information J(A|B) for the measurement
    projectors ``prjs`` on B."""
    p_a = ptr(p_ab, (2, 2), 0)

    def fn(prjs):
        out = entropy(p_a)
        for prj in prjs:
            PB = ikron(to_device(np.asarray(prj), device=p_ab.device,
                                 dtype=p_ab.dtype), (2, 2), 1)
            prob = float(torch.real(torch.trace(PB @ p_ab)))
            if prob > 1e-12:
                out -= prob * entropy(ptr(PB @ p_ab @ PB / prob, (2, 2), 0))
        return out

    return fn if precomp_func else fn(prjs)


def quantum_discord(p, dims=(2, 2), sysa=0, sysb=1, method="COBYLA",
                    tol=1e-12, maxiter=2**14):
    """The quantum discord, by optimising the measurement basis on B with
    scipy (COBYLA by default) on the host, from three starts as quimb_tpu
    (reference ``quantum_discord`` calc.py:951)."""
    from scipy.optimize import minimize

    p = dop(p)
    iab = mutinf(p, dims)

    def trial(x):
        theta, phi = x
        v = np.array([math.cos(theta / 2),
                      math.sin(theta / 2) * np.exp(1j * phi)])
        prj0 = np.outer(v, v.conj())
        return iab - one_way_classical_information(
            p, [prj0, np.eye(2) - prj0])

    best = np.inf
    for x0 in ([1.0, 1.0], [0.5, 2.0], [2.0, 0.5]):
        res = minimize(trial, x0, method=method, tol=tol,
                       options={"maxiter": maxiter})
        best = min(best, res.fun)
    return float(max(best, 0.0))


def trace_distance(p1, p2):
    """The trace distance of two states (reference ``trace_distance``)."""
    if isvec(p1) and isvec(p2):
        F2 = torch.abs(torch.vdot(_flat(p1), _flat(p2))) ** 2
        return float(torch.sqrt(1 - F2))
    return float(0.5 * norm(dop(p1) - dop(p2), "tr"))


def cprint(psi, prec=6):
    """Print a state in computational-basis notation."""
    psi = to_host(psi).reshape(-1)
    n = int(round(math.log2(psi.size)))
    parts = [f"({c:.{prec}g})|{i:0{n}b}>" for i, c in enumerate(psi)
             if abs(c) > 10.0 ** (-prec)]
    print(" + ".join(parts))


def decomp(a, fn, fn_args, fn_d, nmlz_func, mode="p", tol=1e-3):
    """Decompose ``a`` in the Hilbert-Schmidt basis of the products of
    ``fn(x)`` over ``fn_args`` (reference ``decomp`` calc.py:1098): all
    basis operators stacked into one contraction on ``a``'s device.
    ``mode`` holds 'p' to print the contributions above 1e-2 and 'c' to
    return an ordered dict by descending |coefficient|."""
    if isvec(a):
        a = dop(a)
    n = infer_size(a, base=fn_d)
    names, ops = [], []
    nm = nmlz_func(n)
    for perm in itertools.product(fn_args, repeat=n):
        op = functools.reduce(np.kron, (to_host(fn(x)) for x in perm))
        if op.shape[-1] == 1:  # a basis of states (the Bell states)
            op = op @ np.conj(op.T)
        names.append("".join(str(x) for x in perm))
        ops.append(op * nm)
    O = to_device(np.stack(ops), device=a.device,
                  dtype=torch.promote_types(a.dtype, torch.complex64))
    cffs = to_host(torch.real(torch.einsum("kij,ji->k", O, a.to(O.dtype))))
    out = collections.OrderedDict(
        (k, float(v)) for k, v in sorted(zip(names, cffs),
                                         key=lambda kv: -abs(kv[1])))
    if "p" in mode:
        dps = int(round(0.5 - np.log10(1.001 * tol)))
        for k, v in out.items():
            if abs(v) < 0.01:
                break
            print(k, "{: .{prec}f}".format(v, prec=dps))
    if "c" in mode:
        return out


def pauli_decomp(a, mode="p", tol=1e-3):
    """The Pauli-string components of ``a`` (reference ``pauli_decomp``
    calc.py:1160)."""
    return decomp(a, fn=_pauli_np, fn_args="IXYZ", fn_d=2,
                  nmlz_func=lambda n: 2.0 ** -n, mode=mode, tol=tol)


def bell_decomp(a, mode="p", tol=1e-3):
    """The components of ``a`` in the product Bell basis (reference
    ``bell_decomp`` calc.py:1165)."""
    from .gen.states import bell_state

    return decomp(a, fn=lambda s: bell_state(s, device="cpu"),
                  fn_args=(0, 1, 2, 3), fn_d=4, nmlz_func=lambda n: 1.0,
                  mode=mode, tol=tol)


def correlation(p, A, B, sysa, sysb, dims=None, sparse=None,
                precomp_func=False):
    """The correlation <A_a B_b> - <A_a><B_b> (reference
    ``correlation``)."""
    if dims is None:
        dims = (2,) * int(round(math.log2(np.shape(p)[0])))
    dev, dt = p.device, torch.promote_types(p.dtype, torch.complex64)
    A = to_device(to_host(A), device=dev, dtype=dt)
    B = to_device(to_host(B), device=dev, dtype=dt)
    OA, OB = ikron(A, dims, sysa), ikron(B, dims, sysb)
    OAB = ikron([A, B], dims, (sysa, sysb))

    def fn(state):
        state = state.to(dt)
        eab, ea, eb = (float(expectation(O, state)) for O in (OAB, OA, OB))
        return eab - ea * eb

    return fn if precomp_func else fn(p)


def pauli_correlations(p, ss=("xx", "yy", "zz"), sysa=0, sysb=1,
                       sum_abs=False, precomp_func=False):
    """The Pauli correlations <s_a s_b> - <s_a><s_b> (reference
    ``pauli_correlations``)."""
    fs = tuple(correlation(p, _pauli_np(s[0]), _pauli_np(s[1]), sysa, sysb,
                           precomp_func=precomp_func) for s in ss)
    if sum_abs:
        if precomp_func:
            return lambda state: sum(abs(f(state)) for f in fs)
        return sum(abs(f) for f in fs)
    return fs


def ent_cross_matrix(p, sz_blc=1, ent_fn=logneg, calc_self_ent=True,
                     upscale=False):
    """The block-entanglement cross matrix (reference
    ``ent_cross_matrix``)."""
    n = int(round(math.log2(p.shape[0])))
    nb = n // sz_blc
    dims = (2,) * n
    out = np.zeros((nb, nb))
    for i in range(nb):
        for j in range(i, nb):
            sysa = tuple(range(i * sz_blc, (i + 1) * sz_blc))
            sysb = tuple(range(j * sz_blc, (j + 1) * sz_blc))
            if i == j:
                out[i, j] = entropy(ptr(p, dims, sysa)) if calc_self_ent \
                    else np.nan
            else:
                out[i, j] = out[j, i] = ent_fn(
                    ptr(p, dims, sysa + sysb), (2,) * (2 * sz_blc),
                    tuple(range(sz_blc)))
    return out


def qid(p, dims, inds, precomp_func=False, sparse_comp=True,
        norm_func=None, power=2, coeff=1):
    """The quantumness identifiers (reference ``qid``): by default the
    spectral norm of each commutator with the Pauli matrices."""
    if norm_func is None:
        norm_func = lambda x: float(norm_2(x))  # noqa: E731

    def fn(state):
        rho = dop(state)
        out = []
        for i in inds:
            tot = 0.0
            for s in "xyz":
                S = ikron(to_device(_pauli_np(s), device=rho.device,
                                    dtype=rho.dtype), dims, i)
                tot += coeff * norm_func(S @ rho - rho @ S) ** power
            out.append(tot)
        return np.array(out)

    return fn if precomp_func else fn(p)


def is_degenerate(op, tol=1e-12):
    """The number of degeneracies in the spectrum (0 if none)."""
    if isinstance(op, (list, tuple, np.ndarray)) and np.ndim(op) == 1:
        el = np.sort(np.asarray(op))
    else:
        el = to_host(torch.linalg.eigvalsh(op))
    scale = max(abs(el[0]), abs(el[-1]), 1e-300)
    return int(np.sum(np.diff(el) < tol * scale))


def is_eigenvector(x, A, tol=1e-14):
    """Whether ``x`` is an eigenvector of ``A``."""
    x = x.reshape(-1, 1).to(torch.promote_types(x.dtype, A.dtype))
    y = A.to(x.dtype) @ x
    lam = (dag(x) @ y)[0, 0]
    resid = float(torch.linalg.norm(y - lam * x))
    return resid < tol * max(1.0, abs(complex(lam)))


def page_entropy(sz_subsys, sz_total):
    """The Page (average) entropy in bits of a subsystem of dimension
    ``sz_subsys`` of a random pure state of dimension ``sz_total``
    (reference ``page_entropy`` calc.py:1439)."""
    if sz_subsys > sz_total**0.5:
        sz_subsys = sz_total // sz_subsys
    n = sz_total // sz_subsys
    s = sum(1.0 / k for k in range(n + 1, sz_total + 1))
    s -= (sz_subsys - 1) / (2 * n)
    return s / math.log(2)


def heisenberg_energy(L):
    """Asymptotic ground energy of the length-``L`` spin-1/2 isotropic
    antiferromagnetic Heisenberg chain (spin-operator convention), from
    the scaling formula of Nickel, J. Phys. Commun. 1, 055021 (2017)."""
    Einf = (0.5 - 2 * math.log(2)) * L
    Efinite = math.pi**2 / (6 * L)
    correction = 1 + 0.375 / math.log(L) ** 3
    return (Einf - Efinite * correction) / 2


__all__ = [
    "fidelity", "purify", "dephase", "kraus_op", "projector", "measure",
    "simulate_counts", "entropy", "entropy_subsys", "mutinf",
    "mutual_information", "mutinf_subsys", "schmidt_gap", "tr_sqrt",
    "tr_sqrt_subsys", "partial_transpose", "partial_transpose_norm",
    "logneg", "logarithmic_negativity", "logneg_subsys", "negativity",
    "concurrence", "one_way_classical_information", "quantum_discord",
    "trace_distance", "cprint", "decomp", "pauli_decomp", "bell_decomp",
    "correlation", "pauli_correlations", "ent_cross_matrix", "qid",
    "is_degenerate", "is_eigenvector", "page_entropy",
    "heisenberg_energy",
]
