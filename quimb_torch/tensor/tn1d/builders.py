"""Builders of 1D states and Hamiltonians, at array level.

Port of the open-chain parts of ``quimb_tpu/tensor/tn1d/builders.py``
(``MPS_rand_state``, the product states, ``SpinHam1D``, ``MPO_ham_heis``
and the ``ham_1d_*`` builders). The states and operators come out as the
uniform site-tensor lists the DMRG and TEBD engines sweep over:

- an MPO as tensors ``(wl, wr, u, d)``, the chain's ends padded with
  size-1 bonds (what ``quimb_tpu``'s ``dmrg._mpo_uniform_arrays`` gives);
- an MPS as tensors ``(l, p, r)``, padded the same way.

The ``ham_1d_*`` builders return a :class:`~.tebd.LocalHam1D` of host
numpy terms. Every tensor lands on ``device``, the GPU unless the caller
names another (``config.DEFAULT_DEVICE``).
"""

import math

import numpy as np
import torch

from ...config import DEFAULT_DTYPE, DEFAULT_REAL_DTYPE
from ...gen.operators import _spin_op_np
from ...ops.backend import resolve_device, to_device


def MPS_rand_state(L, bond_dim, phys_dim=2, normalize=True, dtype=None,
                   seed=None, device=None):
    """Random open-chain MPS with bond dimension ``bond_dim``, as ``L``
    tensors ``(l, p, r)``. Entries are standard normal, drawn from
    ``np.random.default_rng(seed)``.

    With ``normalize``, every tensor is scaled by the same factor so
    that ⟨ψ|ψ⟩ = 1. The norm is computed in float64 with the running
    environment rescaled at each site, so long chains neither overflow
    nor underflow, whatever ``dtype``.
    """
    dtype = dtype or DEFAULT_REAL_DTYPE
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    arrays = []
    for i in range(L):
        chil = min(bond_dim, phys_dim**i, phys_dim ** (L - i))
        chir = min(bond_dim, phys_dim ** (i + 1), phys_dim ** (L - i - 1))
        arrays.append(rng.standard_normal((chil, phys_dim, chir)))
    if normalize:
        env = np.ones((1, 1))
        log_nrm2 = 0.0
        for A in arrays:
            env = np.einsum("ab,apx,bpy->xy", env, A, A)
            scale = np.linalg.norm(env)
            env = env / scale
            log_nrm2 += math.log(scale)
        log_nrm2 += math.log(env.item())
        f = math.exp(-log_nrm2 / (2 * L))
        arrays = [A * f for A in arrays]
    return [to_device(A, device=device, dtype=dtype) for A in arrays]


def MPS_product_state(arrays, dtype=None, device=None):
    """Product-state MPS from single-site vectors, as tensors ``(1, p, 1)``
    in ``dtype`` (the vectors' own when ``None``)."""
    device = resolve_device(device)
    return [to_device(np.reshape(np.asarray(a), (1, -1, 1)), device=device,
                      dtype=dtype) for a in arrays]


def MPS_computational_state(binary, dtype=None, device=None):
    """MPS of a computational basis state such as ``"01101"``."""
    return MPS_product_state([np.eye(2)[int(b)] for b in binary],
                             dtype=dtype or DEFAULT_REAL_DTYPE, device=device)


def MPS_neel_state(L, down_first=False, dtype=None, device=None):
    """The Néel state ``0101...`` (``1010...`` with ``down_first``)."""
    binary = ("10" if down_first else "01") * L
    return MPS_computational_state(binary[:L], dtype=dtype, device=device)


class SpinHam1D:
    """Nearest-neighbour spin-chain Hamiltonian, built into an MPO by the
    standard finite-state-machine construction (open chains only) or into
    a :class:`~.tebd.LocalHam1D` for TEBD. Operators are the labels of
    :func:`quimb_torch.gen.operators._spin_op_np` or matrices."""

    def __init__(self, S=1 / 2, cyclic=False):
        self.S = S
        self.cyclic = cyclic
        self.one_site_terms = []
        self.two_site_terms = []

    def add_term(self, factor, *operators):
        if factor == 0.0:
            return
        if len(operators) == 1:
            self.one_site_terms.append((factor, *operators))
        elif len(operators) == 2:
            self.two_site_terms.append((factor, *operators))
        else:
            raise NotImplementedError("3-body+ terms not supported")

    def sub_term(self, factor, *operators):
        self.add_term(-factor, *operators)

    def __iadd__(self, term):
        self.add_term(*term)
        return self

    def __isub__(self, term):
        self.sub_term(*term)
        return self

    def _op(self, s):
        if isinstance(s, str):
            return _spin_op_np(s, float(self.S))
        return np.asarray(s)

    def _sum_one_site(self, terms):
        d = int(2 * self.S + 1)
        H = np.zeros((d, d), dtype=complex)
        for factor, s in terms:
            H = H + factor * self._op(s)
        return H

    def _sum_two_site(self, terms):
        d = int(2 * self.S + 1)
        H = np.zeros((d * d, d * d), dtype=complex)
        for factor, s1, s2 in terms:
            H = H + factor * np.kron(self._op(s1), self._op(s2))
        return H

    def build_local_ham(self, L):
        """The :class:`~.tebd.LocalHam1D` (TEBD) form on ``L`` sites."""
        from .tebd import LocalHam1D

        H2 = self._sum_two_site(self.two_site_terms) \
            if self.two_site_terms else None
        H1 = self._sum_one_site(self.one_site_terms) \
            if self.one_site_terms else None
        return LocalHam1D(L=L, H2=H2, H1=H1, cyclic=self.cyclic)

    def _mpo_tensor(self, one_terms, two_terms):
        """The bulk MPO tensor W[D, D, d, d] of the finite-state machine:
        channel 0 carries the identity string, channel D - 1 the finished
        terms (Schur form)."""
        d = int(2 * self.S + 1)
        D = len(two_terms) + 2
        W = np.zeros((D, D, d, d), dtype=complex)
        I = np.eye(d, dtype=complex)
        W[0, 0] = I
        for k, (factor, s1, s2) in enumerate(two_terms):
            # start -> intermediate k with factor * op1 ...
            W[0, k + 1] = factor * self._op(s1)
            # ... intermediate k -> end with op2
            W[k + 1, D - 1] = self._op(s2)
        if one_terms:
            W[0, D - 1] = self._sum_one_site(one_terms)
        W[D - 1, D - 1] = I
        return W

    def build_mpo(self, L, dtype=None, device=None):
        """The MPO as ``L`` tensors ``(wl, wr, u, d)``: the bulk tensor,
        with its first row kept on site 0 and its last column on site
        ``L - 1``. A real operator comes out in the real counterpart of
        ``dtype``."""
        if self.cyclic:
            raise NotImplementedError(
                "a cyclic MPO needs the tensor-network object layer "
                "(ROADMAP queue 1, item 14)")
        dtype = dtype or DEFAULT_DTYPE
        device = resolve_device(device)
        W = self._mpo_tensor(self.one_site_terms, self.two_site_terms)
        D = W.shape[0]
        if np.allclose(W.imag, 0):
            W = W.real
            dtype = dtype.to_real()
        arrays = []
        for i in range(L):
            arr = W
            if i == 0:
                arr = arr[0:1, :]
            if i == L - 1:
                arr = arr[:, D - 1:D]
            arrays.append(to_device(np.ascontiguousarray(arr),
                                    device=device, dtype=dtype))
        return arrays


def _ham_heis_builder(j=1.0, bz=0.0, S=1 / 2, cyclic=False):
    H = SpinHam1D(S=S, cyclic=cyclic)
    try:
        jx, jy, jz = j
    except (TypeError, ValueError):
        jx = jy = jz = j
    if jx == jy and jx != 0:
        H += jx / 2, "+", "-"
        H += jx / 2, "-", "+"
    else:
        if jx:
            H += jx, "X", "X"
        if jy:
            H += jy, "Y", "Y"
    if jz:
        H += jz, "Z", "Z"
    if bz:
        H -= bz, "Z"
    return H


def MPO_ham_heis(L, j=1.0, bz=0.0, S=1 / 2, dtype=None, device=None):
    """Heisenberg Hamiltonian on an open chain of ``L`` spins, as ``L``
    MPO tensors ``(wl, wr, u, d)``."""
    return _ham_heis_builder(j, bz, S).build_mpo(L, dtype=dtype,
                                                 device=device)


def ham_1d_heis(L, j=1.0, bz=0.0, S=1 / 2, cyclic=False):
    """Heisenberg Hamiltonian as a :class:`~.tebd.LocalHam1D`."""
    return _ham_heis_builder(j, bz, S, cyclic).build_local_ham(L)


def ham_1d_XY(L, j=1.0, bz=0.0, S=1 / 2, cyclic=False):
    """XY model: the Heisenberg builder with ``jz = 0``."""
    try:
        jx, jy = j
    except (TypeError, ValueError):
        jx = jy = j
    return ham_1d_heis(L, j=(jx, jy, 0.0), bz=bz, S=S, cyclic=cyclic)


def _ham_ising_builder(j=1.0, bx=0.0, S=1 / 2, cyclic=False):
    H = SpinHam1D(S=S, cyclic=cyclic)
    H += 4 * j, "Z", "Z"
    H -= 2 * bx, "X"
    return H


def ham_1d_ising(L, j=4.0, bx=2.0, S=1 / 2, cyclic=False):
    """Transverse-field Ising model, ``j/4 ΣZZ − bx/2 ΣX`` in spin
    operators (quimb's Pauli-style ``j`` and ``bx``)."""
    return _ham_ising_builder(j / 4, bx / 2, S, cyclic).build_local_ham(L)


def ham_1d_XXZ(L, delta=None, jxy=1.0, S=1 / 2, cyclic=False):
    """XXZ model: ``jxy (XX + YY) + delta ZZ``."""
    if delta is None:
        raise ValueError("must specify delta")
    try:
        jx, jy = jxy
    except (TypeError, ValueError):
        jx = jy = jxy
    return ham_1d_heis(L, j=(jx, jy, delta), S=S, cyclic=cyclic)


def _ham_bilinear_biquadratic_builder(theta, S=1 / 2, cyclic=False):
    """``cos(theta) S.S + sin(theta) (S.S)^2``, the square expanded into
    products of single-site operators."""
    H = SpinHam1D(S=S, cyclic=cyclic)
    cost, sint = math.cos(theta), math.sin(theta)
    for s in ("X", "Y", "Z"):
        H += cost, s, s
    for s1 in ("X", "Y", "Z"):
        for t1 in ("X", "Y", "Z"):
            op = _spin_op_np(s1, S) @ _spin_op_np(t1, S)
            H += sint, op, op
    return H


def ham_1d_bilinear_biquadratic(L, theta=0, S=1 / 2, cyclic=False):
    """Bilinear-biquadratic spin model as a :class:`~.tebd.LocalHam1D`."""
    return _ham_bilinear_biquadratic_builder(
        theta, S=S, cyclic=cyclic).build_local_ham(L)
