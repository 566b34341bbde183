"""Spin operators and the spin-chain Hamiltonians of the exact layer.

Port of the matching parts of ``quimb_tpu/gen/operators.py``: the numpy
spin-S matrices that the MPO builders use, ``pauli`` and ``spin_operator``
as tensors on a device, and ``ham_heis``, ``ham_ising`` and ``ham_XY``,
built from their terms by :func:`quimb_torch.core.ham_from_terms`. Copied
rather than imported: importing anything of quimb_tpu imports JAX."""

import math

import numpy as np

from ..config import DEFAULT_DTYPE
from ..core import ham_from_terms
from ..ops.backend import resolve_device, to_device

_PAULI = {
    "I": np.eye(2, dtype=complex),
    "X": np.array([[0, 1], [1, 0]], dtype=complex),
    "Y": np.array([[0, -1j], [1j, 0]], dtype=complex),
    "Z": np.array([[1, 0], [0, -1]], dtype=complex),
}


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
                     dtype=dtype or DEFAULT_DTYPE)


def pauli(xyz, dim=2, dtype=None, device=None):
    """Pauli operator 'I', 'X', 'Y' or 'Z'; for ``dim > 2`` twice the
    spin-(dim - 1)/2 operator."""
    if dim != 2:
        return spin_operator(xyz, S=(dim - 1) / 2, dtype=dtype,
                             device=device) * 2.0
    return to_device(_PAULI[str(xyz).upper()], device=resolve_device(device),
                     dtype=dtype or DEFAULT_DTYPE)


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
