"""Spin-S operator matrices (numpy), as ``quimb_tpu/gen/operators.py``
builds them for the MPO builders. Copied rather than imported: importing
anything of quimb_tpu imports JAX."""

import math

import numpy as np


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
