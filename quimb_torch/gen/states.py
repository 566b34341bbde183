"""Computational-basis states of the exact layer, as (d, 1) kets.

Port of ``basis_vec``, ``up``, ``down``, ``computational_state`` and
``neel_state`` of ``quimb_tpu/gen/states.py``. Each builds its ket in
``dtype`` (complex128 by default) directly on ``device``, the GPU unless
the caller names another."""

import torch

from ..config import DEFAULT_DTYPE
from ..core import quimbify
from ..ops.backend import resolve_device


def basis_vec(i, dim, dtype=None, qtype="ket", device=None):
    """The ``i``-th computational basis ket of dimension ``dim``."""
    x = torch.zeros(dim, dtype=dtype or DEFAULT_DTYPE,
                    device=resolve_device(device))
    x[i] = 1.0
    return quimbify(x, qtype=qtype, dtype=x.dtype)


def up(qtype="ket", dtype=None, device=None):
    return basis_vec(0, 2, dtype=dtype, qtype=qtype, device=device)


zplus = up


def down(qtype="ket", dtype=None, device=None):
    return basis_vec(1, 2, dtype=dtype, qtype=qtype, device=device)


zminus = down


def computational_state(binary, qtype="ket", dtype=None, device=None):
    """The ket of a binary string such as '0101' (or a sequence of 0s and
    1s), site 0 first."""
    if isinstance(binary, (tuple, list)):
        binary = "".join(map(str, binary))
    return basis_vec(int(binary, 2), 2 ** len(binary), dtype=dtype,
                     qtype=qtype, device=device)


def neel_state(n, down_first=False, dtype=None, device=None):
    """The alternating product state '0101..' ('1010..' with
    ``down_first``)."""
    s = "10" if down_first else "01"
    return computational_state((s * n)[:n], dtype=dtype, device=device)
