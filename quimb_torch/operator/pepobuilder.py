"""Exact PEPO construction for nearest-neighbor 2D Hamiltonians.

Port of ``quimb_tpu/operator/pepobuilder.py`` onto the port's ``PEPO``,
the analogue of the reference's ``quimb/operator/pepobuilder.py``:
a finite-state-machine over the lattice bonds builds

    H = sum_k sum_<ij> A_k(i) B_k(j)  +  sum_i C(i)

as a bond-dimension ``2 + n_pairs`` PEPO, generalizing the reference's
single-(A, B) construction to a list of interaction pairs (so e.g. the
Heisenberg model needs one PEPO, not three).

FSM design (own derivation): a single "particle" line runs from the
corner (0, 0) up the left spine and branches right into each row; the
site where the line terminates either applies an on-site term or emits
an interaction excitation to its upper/right neighbor, which applies
the closing operator. Every complete FSM configuration contributes
exactly one Hamiltonian term; all other sites carry identity.

Bond-leg states: 0 = vacuum, 1 = particle, 2+k = excitation of
interaction pair k.
"""

import numpy as np
import torch

from ..config import get_default_dtype
from ..ops.backend import resolve_device, to_device, to_torch_dtype
from ..tensor.tn2d.core import PEPO

__all__ = ["pepo_nearest_neighbor", "PEPO_nearest_neighbor"]


def _w_array(Lx, Ly, i, j, pairs, C, dtype):
    """The FSM site array at (i, j), layout (u, r, d, l, k, b) with
    open-boundary legs projected out."""
    K = len(pairs)
    D = 2 + K
    p = pairs[0][0].shape[0] if pairs else C.shape[0]
    VAC, PAR = 0, 1

    I = np.eye(p, dtype=dtype)
    W = np.zeros((D, D, D, D, p, p), dtype=dtype)

    def sel(base=None, **legs):
        s = [VAC] * 4 + [slice(None)] * 2 if base is None else list(base)
        for leg, v in legs.items():
            s["urdl".index(leg)] = v
        return tuple(s)

    # all-vacuum: identity
    W[sel()] = I

    # particle routing: corner sources the line; the left spine
    # propagates it up and branches right; rows propagate it right
    if i == 0 and j == 0:
        d_in, d_out = "", "ur"
    elif j == 0:
        d_in, d_out = "d", "ur"
    else:
        d_in, d_out = "l", "r"

    sin = sel(**{leg: PAR for leg in d_in})

    # line terminates here with the on-site term (for the corner this
    # overwrites the identity: the all-vacuum configuration IS the
    # corner's termination)
    W[sin] = C
    # pass the line through
    for leg in d_out:
        W[sel(sin, **{leg: PAR})] = I

    # start an interaction toward the upper/right neighbor
    for k, (A, _) in enumerate(pairs):
        for leg in "ur":
            W[sel(sin, **{leg: 2 + k})] = A

    # close an interaction arriving from below/left (all other legs
    # vacuum: the closing site is never on the particle line)
    for k, (_, B) in enumerate(pairs):
        W[sel(d=2 + k)] = B
        W[sel(l=2 + k)] = B

    # project open-boundary legs to vacuum
    slicer = tuple(
        VAC if bdry else slice(None)
        for bdry in (i == Lx - 1, j == Ly - 1, i == 0, j == 0)
    ) + (slice(None), slice(None))
    return W[slicer]


def pepo_nearest_neighbor(
    Lx, Ly, pairs, onsite=None, dtype=None, device=None, **pepo_opts
):
    """Build the PEPO for ``H = sum_k sum_<ij> A_k(i) B_k(j) +
    sum_i C(i)`` on an ``Lx x Ly`` open lattice, its tensors on ``device``
    (the GPU by default).

    Parameters
    ----------
    pairs : sequence of (array, array)
        The (left/lower, right/upper) factors of each interaction.
    onsite : array, optional
        The on-site term ``C``.

    Returns
    -------
    PEPO
        Exact operator with bond dimension ``2 + len(pairs)``, in
        ``dtype`` (complex128 by default), real when every array is.
    """
    pairs = [
        (np.asarray(A, dtype=complex), np.asarray(B, dtype=complex))
        for A, B in pairs
    ]
    if onsite is None:
        # zero on-site term keeps the FSM uniform
        p = pairs[0][0].shape[0]
        C = np.zeros((p, p), dtype=complex)
    else:
        C = np.asarray(onsite, dtype=complex)

    out_dtype = to_torch_dtype(dtype or get_default_dtype())
    device = resolve_device(device)
    Ws = [
        [
            _w_array(Lx, Ly, i, j, pairs, C, dtype=complex)
            for j in range(Ly)
        ]
        for i in range(Lx)
    ]
    # drop to real storage when possible
    if all(np.allclose(w.imag, 0) for row in Ws for w in row):
        out_dtype = torch.empty(0, dtype=out_dtype).real.dtype
        Ws = [[w.real for w in row] for row in Ws]
    Ws = [[to_device(w, device=device, dtype=out_dtype) for w in row]
          for row in Ws]
    return PEPO(Ws, shape="urdlkb", **pepo_opts)


def PEPO_nearest_neighbor(A, B, C, Lx, Ly, dtype=None, device=None,
                          **pepo_opts):
    """Single-interaction-pair wrapper matching the reference signature
    (``H = sum_<ij> A_i B_j + sum_i C_i``)."""
    return pepo_nearest_neighbor(
        Lx, Ly, [(A, B)], onsite=C, dtype=dtype, device=device, **pepo_opts
    )
