"""States of the exact layer, as (d, 1) kets or density operators.

Port of ``quimb_tpu/gen/states.py``: basis vectors, the spin states, Bloch,
Bell, GHZ, W and Werner states, thermal states, antisymmetrised and graph
states. Each builds its state in ``dtype`` (complex128 by default) on
``device``, the GPU unless the caller names another."""

import itertools
import math

import numpy as np
import torch

from ..config import get_default_dtype
from ..core import ikron, kron, pkron, quimbify
from ..ops.backend import resolve_device


def basis_vec(i, dim, ownership=None, dtype=None, qtype="ket", sparse=False,
              device=None):
    """The ``i``-th computational basis ket of dimension ``dim``, dense on
    ``device``. ``ownership`` and ``sparse`` are accepted and ignored, as
    quimb_tpu ignores them (its ket is always dense)."""
    x = torch.zeros(dim, dtype=dtype or get_default_dtype(),
                    device=resolve_device(device))
    x[i] = 1.0
    return quimbify(x, qtype=qtype, dtype=x.dtype)


def _qu(data, qtype, dtype, device):
    return quimbify(np.asarray(data), qtype=qtype, dtype=dtype,
                    device=device)


def up(qtype="ket", dtype=None, device=None):
    return basis_vec(0, 2, dtype=dtype, qtype=qtype, device=device)


zplus = up


def down(qtype="ket", dtype=None, device=None):
    return basis_vec(1, 2, dtype=dtype, qtype=qtype, device=device)


zminus = down


def plus(qtype="ket", dtype=None, device=None):
    s = 1 / math.sqrt(2)
    return _qu([s, s], qtype, dtype, device)


xplus = plus


def minus(qtype="ket", dtype=None, device=None):
    s = 1 / math.sqrt(2)
    return _qu([s, -s], qtype, dtype, device)


xminus = minus


def yplus(qtype="ket", dtype=None, device=None):
    s = 1 / math.sqrt(2)
    return _qu([s, 1j * s], qtype, dtype, device)


def yminus(qtype="ket", dtype=None, device=None):
    s = 1 / math.sqrt(2)
    return _qu([s, -1j * s], qtype, dtype, device)


def bloch_state(ax, ay, az, purified=False, dtype=None, sparse=False,
                device=None):
    """The density operator at Bloch coordinates (ax, ay, az); dense
    whatever ``sparse`` says, as quimb_tpu's."""
    if purified:
        norm = math.sqrt(ax**2 + ay**2 + az**2)
        ax, ay, az = ax / norm, ay / norm, az / norm
    rho = 0.5 * np.array([[1 + az, ax - 1j * ay], [ax + 1j * ay, 1 - az]])
    return _qu(rho, "dop", dtype, device)


def bell_state(s, qtype="ket", dtype=None, device=None):
    """One of the four Bell states: 'phi+', 'phi-', 'psi+', 'psi-' (or
    3, 2, 1, 0)."""
    keymap = {"psi-": "psi-", 0: "psi-", "psi+": "psi+", 1: "psi+",
              "phi-": "phi-", 2: "phi-", "phi+": "phi+", 3: "phi+"}
    isq2 = 1 / math.sqrt(2)
    vec = {"phi+": [isq2, 0, 0, isq2], "phi-": [isq2, 0, 0, -isq2],
           "psi+": [0, isq2, isq2, 0], "psi-": [0, isq2, -isq2, 0]}
    return _qu(vec[keymap[s]], qtype, dtype, device)


def singlet(qtype="ket", dtype=None, device=None):
    return bell_state("psi-", qtype=qtype, dtype=dtype, device=device)


def thermal_state(ham, beta, precomp_func=False):
    """The thermal density operator exp(-beta H) / Z of the dense tensor
    ``ham``, on its device; with ``precomp_func`` a function of beta."""
    w, V = torch.linalg.eigh(ham)

    def gen(b):
        p = torch.exp(-b * (w - torch.min(w)))
        p = (p / torch.sum(p)).to(V.dtype)
        return (V * p) @ V.conj().T

    return gen if precomp_func else gen(beta)


def computational_state(binary, qtype="ket", dtype=None, sparse=False,
                        device=None):
    """The ket of a binary string such as '0101' (or a sequence of 0s and
    1s), site 0 first; dense whatever ``sparse`` says, as quimb_tpu's."""
    if isinstance(binary, (tuple, list)):
        binary = "".join(map(str, binary))
    return basis_vec(int(binary, 2), 2 ** len(binary), dtype=dtype,
                     qtype=qtype, device=device)


def neel_state(n, down_first=False, dtype=None, device=None):
    """The alternating product state '0101..' ('1010..' with
    ``down_first``)."""
    s = "10" if down_first else "01"
    return computational_state((s * n)[:n], dtype=dtype, device=device)


def singlet_pairs(n, dtype=None, device=None):
    """The product of singlets on neighbouring pairs."""
    return kron(*(singlet(dtype=dtype, device=device)
                  for _ in range(n // 2)))


def werner_state(p, dtype=None, device=None):
    """The Werner state p |psi-><psi-| + (1 - p) I / 4."""
    s = singlet(dtype=dtype, device=device)
    return p * (s @ s.conj().T) + (1 - p) * torch.eye(
        4, dtype=s.dtype, device=s.device) / 4


def ghz_state(n, qtype="ket", dtype=None, device=None):
    x = np.zeros(2**n)
    x[0] = x[-1] = 1 / math.sqrt(2)
    return _qu(x, qtype, dtype, device)


def w_state(n, qtype="ket", dtype=None, device=None):
    x = np.zeros(2**n)
    for i in range(n):
        x[2**i] = 1 / math.sqrt(n)
    return _qu(x, qtype, dtype, device)


def levi_civita(perm):
    """The parity sign of a permutation."""
    n = len(perm)
    sign, seen = 1, [False] * n
    for i in range(n):
        if seen[i]:
            continue
        j, clen = i, 0
        while not seen[j]:
            seen[j] = True
            j = perm[j]
            clen += 1
        if clen % 2 == 0:
            sign = -sign
    return sign


def perm_state(ps):
    """The totally antisymmetrised state of the kets ``ps``."""
    out = None
    for perm in itertools.permutations(range(len(ps))):
        term = kron(*(ps[i] for i in perm)) * levi_civita(perm)
        out = term if out is None else out + term
    return out / torch.linalg.norm(out)


def graph_state_1d(n, cyclic=True, sparse=False, dtype=None, device=None):
    """The 1D graph state: plus states entangled by CZ gates; dense
    whatever ``sparse`` says, as quimb_tpu's."""
    from .operators import cZ

    psi = kron(*(plus(dtype=dtype, device=device) for _ in range(n)))
    CZ = cZ(dtype=dtype, device=device)
    for i in range(n - 1):
        psi = ikron(CZ, (2,) * n, (i, i + 1)) @ psi
    if cyclic and n > 2:
        psi = pkron(CZ, (2,) * n, (n - 1, 0)) @ psi
    return psi


__all__ = [
    "basis_vec", "up", "zplus", "down", "zminus", "plus", "xplus", "minus",
    "xminus", "yplus", "yminus", "bloch_state", "bell_state", "singlet",
    "thermal_state", "computational_state", "neel_state", "singlet_pairs",
    "werner_state", "ghz_state", "w_state", "levi_civita", "perm_state",
    "graph_state_1d",
]
