"""Operators of the exact layer: Pauli and spin matrices, gates, and the
spin-chain, lattice and MBL Hamiltonians.

Port of ``quimb_tpu/gen/operators.py``. Each builder returns a tensor in
``dtype`` (complex128 by default; ``zspin_projector`` float64) on
``device``, the GPU unless the caller names another; the Hamiltonians are
built from their terms by :func:`quimb_torch.core.ham_from_terms` (with
``sparse`` a host scipy matrix carrying its local terms). The numpy spin-S
matrices are copied rather than imported: importing anything of quimb_tpu
imports JAX. ``ham_mbl`` draws its fields from
``np.random.default_rng(seed)`` exactly as quimb_tpu does.
"""

import functools
import math

import numpy as np

from ..config import get_default_dtype
from ..core import ham_from_terms
from ..ops.backend import resolve_device, to_device, to_torch_dtype

_PAULI = {
    "I": np.eye(2, dtype=complex),
    "X": np.array([[0, 1], [1, 0]], dtype=complex),
    "Y": np.array([[0, -1j], [1j, 0]], dtype=complex),
    "Z": np.array([[1, 0], [0, -1]], dtype=complex),
}


def _asdevice(x, dtype=None, device=None):
    """A host matrix as a tensor in ``dtype`` (complex128 by default) on
    ``device`` (the GPU by default)."""
    return to_device(np.asarray(x), device=resolve_device(device),
                     dtype=to_torch_dtype(dtype or get_default_dtype()))


def _pauli(xyz):
    return _PAULI[str(xyz).upper()]


def _spin_op_np(label, S):
    d = int(2 * S + 1)
    m = np.arange(S, -S - 1, -1)
    if label in ("z", "Z"):
        return np.diag(m).astype(complex)
    # ladder operators
    sp = np.zeros((d, d), dtype=complex)
    for i in range(d - 1):
        mm = m[i + 1]
        sp[i, i + 1] = math.sqrt(S * (S + 1) - mm * (mm + 1))
    if label in ("+", "p"):
        return sp
    if label in ("-", "m"):
        return sp.conj().T
    if label in ("x", "X"):
        return (sp + sp.conj().T) / 2
    if label in ("y", "Y"):
        return (sp - sp.conj().T) / 2j
    if label in ("i", "I"):
        return np.eye(d, dtype=complex)
    raise ValueError(f"unknown spin operator {label}")


def spin_operator(label, S=1 / 2, dtype=None, device=None):
    """Spin-S operator ('x', 'y', 'z', '+', '-', 'i') as a tensor in
    ``dtype`` (complex128 by default) on ``device`` (the GPU by
    default)."""
    return to_device(_spin_op_np(str(label), float(S)),
                     device=resolve_device(device),
                     dtype=dtype or get_default_dtype())


def pauli(xyz, dim=2, dtype=None, device=None):
    """Pauli operator 'I', 'X', 'Y' or 'Z'; for ``dim > 2`` twice the
    spin-(dim - 1)/2 operator."""
    if dim != 2:
        return spin_operator(xyz, S=(dim - 1) / 2, dtype=dtype,
                             device=device) * 2.0
    return to_device(_PAULI[str(xyz).upper()], device=resolve_device(device),
                     dtype=dtype or get_default_dtype())


def identity(d, dtype=None, device=None):
    return _asdevice(np.eye(d), dtype, device)


eye = identity


def hadamard(dtype=None, device=None, sparse=False):
    return _asdevice(np.array([[1, 1], [1, -1]]) / math.sqrt(2), dtype,
                     device)


def phase_gate(phi, dtype=None, device=None, sparse=False):
    return _asdevice(np.diag([1, np.exp(1j * phi)]), dtype, device)


def S_gate(dtype=None, device=None, sparse=False):
    return phase_gate(math.pi / 2, dtype, device)


def T_gate(dtype=None, device=None, sparse=False):
    return phase_gate(math.pi / 4, dtype, device)


def rotation(phi, xyz="Z", dtype=None, device=None, sparse=False):
    """Rotation e^{-i phi/2 sigma_xyz}."""
    import scipy.linalg as sla

    P = np.asarray(_pauli(xyz))
    return _asdevice(sla.expm(-1j * phi / 2 * P), dtype, device)


Rx = functools.partial(rotation, xyz="X")
Ry = functools.partial(rotation, xyz="Y")
Rz = functools.partial(rotation, xyz="Z")


def U_gate(theta, phi, lamda, dtype=None, device=None):
    """General single-qubit U3 gate."""
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return _asdevice(
        np.array([
            [c, -np.exp(1j * lamda) * s],
            [np.exp(1j * phi) * s, np.exp(1j * (phi + lamda)) * c],
        ]),
        dtype, device,
    )


def Xsqrt(dtype=None, device=None, **kwargs):
    return _asdevice(
        0.5 * np.array([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]]), dtype,
        device)


def Ysqrt(dtype=None, device=None, **kwargs):
    return _asdevice(
        0.5 * np.array([[1 + 1j, -1 - 1j], [1 + 1j, 1 + 1j]]), dtype,
        device)


def Zsqrt(dtype=None, device=None, **kwargs):
    return _asdevice(np.diag([1, 1j]), dtype, device)


def Wsqrt(dtype=None, device=None, **kwargs):
    """sqrt(W) with W = (X+Y)/sqrt(2) (the Sycamore gate set)."""
    isq2 = 1 / math.sqrt(2)
    W = isq2 * (np.asarray(_pauli("X")) + np.asarray(_pauli("Y")))
    w, V = np.linalg.eigh(W)
    sqrtW = (V * np.sqrt(w.astype(complex))) @ V.conj().T
    return _asdevice(sqrtW, dtype, device)


def _swap_np(dim=2):
    d = dim
    M = np.zeros((d * d, d * d))
    for a in range(d):
        for b in range(d):
            M[a * d + b, b * d + a] = 1.0
    return M


def swap(dim=2, dtype=None, device=None, **kwargs):
    """SWAP gate for two qudits."""
    return _asdevice(_swap_np(dim), dtype, device)


def iswap(dtype=None, device=None, **kwargs):
    M = np.array([
        [1, 0, 0, 0],
        [0, 0, 1j, 0],
        [0, 1j, 0, 0],
        [0, 0, 0, 1],
    ])
    return _asdevice(M, dtype, device)


def fsim(theta, phi, dtype=None, device=None, **kwargs):
    """The fermionic-simulation gate."""
    c, s = math.cos(theta), math.sin(theta)
    M = np.array([
        [1, 0, 0, 0],
        [0, c, -1j * s, 0],
        [0, -1j * s, c, 0],
        [0, 0, 0, np.exp(-1j * phi)],
    ])
    return _asdevice(M, dtype, device)


def fsimg(theta, zeta, chi, gamma, phi, dtype=None, device=None, **kwargs):
    """General fsim gate (5 parameters)."""
    c, s = math.cos(theta), math.sin(theta)
    M = np.array([
        [1, 0, 0, 0],
        [0, np.exp(-1j * (gamma + zeta)) * c,
         -1j * np.exp(-1j * (gamma - chi)) * s, 0],
        [0, -1j * np.exp(-1j * (gamma + chi)) * s,
         np.exp(-1j * (gamma - zeta)) * c, 0],
        [0, 0, 0, np.exp(-1j * (2 * gamma + phi))],
    ])
    return _asdevice(M, dtype, device)


def ncontrolled_gate(ncontrol, gate, dtype=None, device=None, sparse=False):
    """Build an n-controlled gate."""
    gate = np.asarray(gate)
    d = 2**ncontrol * gate.shape[0]
    M = np.eye(d, dtype=complex)
    M[-gate.shape[0]:, -gate.shape[1]:] = gate
    return _asdevice(M, dtype, device)


def controlled(s, dtype=None, device=None, sparse=False):
    """Controlled version of a named pauli ('x','y','z','not')."""
    s = {"not": "x"}.get(s.lower(), s.lower())
    return ncontrolled_gate(1, np.asarray(_pauli(s)), dtype, device)


CNOT = functools.partial(controlled, "not")


def cX(dtype=None, device=None):
    return controlled("x", dtype, device)


def cY(dtype=None, device=None):
    return controlled("y", dtype, device)


def cZ(dtype=None, device=None):
    return controlled("z", dtype, device)


def ccX(dtype=None, device=None):
    return ncontrolled_gate(2, _pauli("X"), dtype, device)


toffoli = ccX


def ccY(dtype=None, device=None):
    """Double-controlled Y gate (reference ``ccY``
    gen/operators.py:779)."""
    return ncontrolled_gate(2, _pauli("Y"), dtype, device)


def ccZ(dtype=None, device=None):
    """Double-controlled Z gate (reference ``ccZ``
    gen/operators.py:803)."""
    return ncontrolled_gate(2, _pauli("Z"), dtype, device)


def fredkin(dtype=None, device=None):
    # build from the host-side matrix: np.asarray on a complex device
    # array is an eager transfer, which the TPU backend cannot do
    return ncontrolled_gate(1, _swap_np(2), dtype, device)


cswap = fredkin
controlled_swap = fredkin


def shift(dim, power=1, dtype=None, device=None):
    """Cyclic shift operator of dimension ``dim`` raised to ``power``
    (reference ``shift`` gen/operators.py:214)."""
    power = power % dim
    S = np.zeros((dim, dim), dtype=complex)
    for i in range(dim):
        S[(i + power) % dim, i] = 1.0
    return _asdevice(S, dtype, device)


def clock(dim, power=1, dtype=None, device=None):
    """Clock operator diag(w^0, w^p, w^2p, ...) with w the primitive
    dim-th root of unity (reference ``clock``
    gen/operators.py:256)."""
    omega = np.exp(power * 2j * np.pi / dim)
    C = np.diag(omega ** np.arange(dim))
    return _asdevice(C, dtype, device)


def _chain_pairs(n, cyclic):
    pairs = [(i, i + 1) for i in range(n - 1)]
    if cyclic and n > 2:
        pairs.append((n - 1, 0))
    return pairs


def ham_heis(n, j=1.0, b=0.0, cyclic=False, sparse=False, dtype=None,
             device=None):
    """The spin-1/2 Heisenberg chain ``sum J_a S^a_i S^a_{i+1} - sum B_a
    S^a_i``, with ``j`` and ``b`` numbers or (x, y, z) triples. With
    ``sparse`` a host scipy matrix carrying its local terms, for
    :func:`quimb_torch.core.device_operator`; otherwise a dense tensor on
    ``device``, the GPU by default."""
    try:
        jx, jy, jz = j
    except TypeError:
        jx = jy = jz = j
    try:
        bx, by, bz = b
    except TypeError:
        bx, by, bz = 0, 0, b
    S = {s: _spin_op_np(s, 0.5) for s in "xyz"}
    terms = []
    for pair in _chain_pairs(n, cyclic):
        for s, js in zip("xyz", (jx, jy, jz)):
            if js:
                terms.append((js, (S[s], S[s]), pair))
    for i in range(n):
        for s, bs in zip("xyz", (bx, by, bz)):
            if bs:
                terms.append((-bs, (S[s],), (i,)))
    return ham_from_terms(terms, (2,) * n, sparse=sparse, dtype=dtype,
                          device=device)


def ham_ising(n, jz=1.0, bx=1.0, cyclic=False, sparse=False, dtype=None,
              device=None):
    """The transverse-field Ising chain ``sum 4 jz S^z S^z - 2 bx S^x``."""
    S = {s: _spin_op_np(s, 0.5) for s in "xz"}
    terms = [(4 * jz, (S["z"], S["z"]), pair)
             for pair in _chain_pairs(n, cyclic)]
    terms += [(-2 * bx, (S["x"],), (i,)) for i in range(n)]
    return ham_from_terms(terms, (2,) * n, sparse=sparse, dtype=dtype,
                          device=device)


def ham_XY(n, jxy=1.0, bz=0.0, cyclic=False, sparse=False, dtype=None,
           device=None):
    """The XY chain: :func:`ham_heis` with ``j = (jxy, jxy, 0)``."""
    return ham_heis(n, j=(jxy, jxy, 0.0), b=(0, 0, bz), cyclic=cyclic,
                    sparse=sparse, dtype=dtype, device=device)


def ham_XXZ(n, delta, jxy=1.0, cyclic=False, sparse=False, dtype=None,
            device=None):
    """The XXZ chain: :func:`ham_heis` with ``j = (jxy, jxy, delta)``."""
    return ham_heis(n, j=(jxy, jxy, delta), cyclic=cyclic, sparse=sparse,
                    dtype=dtype, device=device)


def ham_mbl(n, dh, j=1.0, seed=None, cyclic=False, dh_dist="s", dh_dim=1,
            beta=None, sparse=False, dtype=None, device=None):
    """Many-body-localized spin hamiltonian: Heisenberg + random fields
    (reference gen/operators.py ham_mbl)."""
    rng = np.random.default_rng(seed)
    dims = (2,) * n
    S = {s: np.asarray(_spin_op_np(s, 0.5)) for s in "xyz"}
    try:
        jx, jy, jz = j
    except TypeError:
        jx = jy = jz = j
    terms = []
    pairs = [(i, i + 1) for i in range(n - 1)]
    if cyclic and n > 2:
        pairs.append((n - 1, 0))
    for (i, k) in pairs:
        for lbl, jj in zip("xyz", (jx, jy, jz)):
            if jj:
                terms.append((jj, (S[lbl], S[lbl]), (i, k)))
    # random fields
    if dh_dist in ("s", "flat", "uniform"):
        hz = rng.uniform(-dh, dh, n)
    elif dh_dist in ("g", "gauss", "normal"):
        hz = rng.normal(0, dh, n)
    else:
        raise ValueError(f"unknown dh_dist {dh_dist}")
    dims_flags = {1: "z", 2: "xy", 3: "xyz", "z": "z"}.get(dh_dim, "z")
    for i in range(n):
        for lbl in dims_flags:
            if lbl == "z":
                terms.append((hz[i], (S["z"],), (i,)))
            else:
                h2 = rng.uniform(-dh, dh)
                terms.append((h2, (S[lbl],), (i,)))
    return ham_from_terms(terms, dims, sparse=sparse, dtype=dtype,
                          device=device)


def ham_j1j2(n, j1=1.0, j2=0.5, bz=0.0, cyclic=False, sparse=False,
             dtype=None, device=None):
    """J1-J2 frustrated Heisenberg chain."""
    dims = (2,) * n
    S = {s: np.asarray(_spin_op_np(s, 0.5)) for s in "xyz"}
    terms = []
    for dist, jj in ((1, j1), (2, j2)):
        for i in range(n - dist if not cyclic else n):
            k = (i + dist) % n
            for lbl in "xyz":
                terms.append((jj, (S[lbl], S[lbl]), (i, k)))
    for i in range(n):
        if bz:
            terms.append((-bz, (S["z"],), (i,)))
    return ham_from_terms(terms, dims, sparse=sparse, dtype=dtype,
                          device=device)


def zspin_projector(n, sz=0, dtype=None, device=None):
    """Projector onto the given total-Sz sector(s) of n spin-1/2s:
    returns the (2^n, D) isometry spanning the sector."""
    if not isinstance(sz, (tuple, list)):
        sz = (sz,)
    target_ups = set()
    for s in sz:
        ups = s + n / 2
        if abs(ups - round(ups)) > 1e-12:
            raise ValueError(f"impossible sz {s} for n {n}")
        target_ups.add(int(round(ups)))
    cols = []
    for config in range(2**n):
        ups = bin(config).count("1")
        if ups in target_ups:
            cols.append(config)
    P = np.zeros((2**n, len(cols)))
    for k, c in enumerate(cols):
        P[c, k] = 1.0
    return _asdevice(P, dtype or "float64", device)


def create(n=2, dtype=None, device=None):
    """Bosonic creation operator truncated at n levels."""
    a = np.diag(np.sqrt(np.arange(1, n)), -1)
    return _asdevice(a, dtype, device)


def destroy(n=2, dtype=None, device=None):
    a = np.diag(np.sqrt(np.arange(1, n)), 1)
    return _asdevice(a, dtype, device)


def num(n=2, dtype=None, device=None):
    return _asdevice(np.diag(np.arange(n)), dtype, device)


def ham_hubbard_hardcore(n, t=0.5, V=1.0, mu=1.0, cyclic=False,
                         sparse=False, dtype=None, device=None):
    """Hard-core boson Hubbard chain."""
    dims = (2,) * n
    # host-side matrices (np.asarray on complex device arrays is an
    # eager transfer the TPU backend cannot do)
    b = np.diag(np.sqrt(np.arange(1, 2)), 1)
    bd = np.diag(np.sqrt(np.arange(1, 2)), -1)
    nop = bd @ b
    terms = []
    pairs = [(i, i + 1) for i in range(n - 1)]
    if cyclic:
        pairs.append((n - 1, 0))
    for (i, k) in pairs:
        terms.append((-t, (bd, b), (i, k)))
        terms.append((-t, (b, bd), (i, k)))
        terms.append((V, (nop, nop), (i, k)))
    for i in range(n):
        terms.append((-mu, (nop,), (i,)))
    return ham_from_terms(terms, dims, sparse=sparse, dtype=dtype,
                          device=device)


def ham_heis_2D(n, m, j=1.0, bz=0.0, cyclic=False, sparse=False,
                dtype=None, device=None):
    """2D lattice Heisenberg Hamiltonian (reference
    gen/operators.py:1277)."""
    N = n * m
    dims = (2,) * N
    S = {s: np.asarray(_spin_op_np(s, 0.5)) for s in "xyz"}
    try:
        jx, jy, jz = j
    except TypeError:
        jx = jy = jz = j

    def site(i, k):
        return i * m + k

    pairs = []
    for i in range(n):
        for k in range(m):
            if k + 1 < m or cyclic:
                pairs.append((site(i, k), site(i, (k + 1) % m)))
            if i + 1 < n or cyclic:
                pairs.append((site(i, k), site((i + 1) % n, k)))
    terms = []
    for (a, b_) in pairs:
        for lbl, jj in zip("xyz", (jx, jy, jz)):
            if jj:
                terms.append((jj, (S[lbl], S[lbl]), (a, b_)))
    for i in range(N):
        if bz:
            terms.append((-bz, (S["z"],), (i,)))
    return ham_from_terms(terms, dims, sparse=sparse, dtype=dtype,
                          device=device)


__all__ = [
    "spin_operator", "pauli", "identity", "eye", "hadamard", "phase_gate",
    "S_gate", "T_gate", "rotation", "Rx", "Ry", "Rz", "U_gate", "Xsqrt",
    "Ysqrt", "Zsqrt", "Wsqrt", "swap", "iswap", "fsim", "fsimg",
    "ncontrolled_gate", "controlled", "CNOT", "cX", "cY", "cZ", "ccX",
    "toffoli", "ccY", "ccZ", "fredkin", "cswap", "controlled_swap",
    "shift", "clock", "ham_heis", "ham_ising", "ham_XY", "ham_XXZ",
    "ham_mbl", "ham_j1j2", "zspin_projector", "create", "destroy", "num",
    "ham_hubbard_hardcore", "ham_heis_2D",
]
