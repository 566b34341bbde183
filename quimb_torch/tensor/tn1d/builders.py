"""Builders of MPS and MPO objects and of 1D Hamiltonians.

Port of ``quimb_tpu/tensor/tn1d/builders.py`` (reference
``quimb/tensor/tensor_builder.py``: ``MPS_rand_state``, ``MPO_ham_heis``
:5498, ``SpinHam1D`` :4967 with the first-order finite-state MPO
construction, the ``ham_1d_*`` builders :5538+). The states come out as
:class:`~.core.MatrixProductState` and the operators as
:class:`~.core.MatrixProductOperator`, with quimb_tpu's signatures plus
``device``: every tensor lands there, the GPU unless the caller names
another (``config.DEFAULT_DEVICE``). The ``ham_1d_*`` builders return a
:class:`~.tebd.LocalHam1D` of host numpy terms.

Random arrays come from ``np.random.default_rng(seed)``: quimb_tpu draws
from JAX's generator, which torch cannot reproduce, so a test carries
quimb_tpu's arrays across with :func:`quimb_torch.convert.from_tpu_mps`.
"""

import math
from numbers import Integral

import numpy as np
import torch

from ...config import DEFAULT_DTYPE, DEFAULT_REAL_DTYPE
from ...gen.operators import _spin_op_np
from ...ops.backend import resolve_device, to_device, to_host, to_torch_dtype
from .core import (
    MatrixProductOperator,
    MatrixProductState,
    _arrays_to_mps,
    _tn_device,
)


def _dtype(dtype, default=DEFAULT_REAL_DTYPE):
    return to_torch_dtype(dtype or default)


def _on(arrays, device, dtype=None):
    """Host arrays -> tensors on ``device`` (resolved) in ``dtype``."""
    device = resolve_device(device)
    return [to_device(a, device=device, dtype=dtype) for a in arrays]


# ---------------------------------------------------------------------------
# MPS builders
# ---------------------------------------------------------------------------


def _rand_state_arrays(L, bond_dim, phys_dim, normalize, cyclic, rng):
    """Standard normal ``(l, p, r)`` host arrays of a random MPS (the
    open chain's ends with size-1 bonds), with every tensor scaled by the
    same factor so that <psi|psi> = 1 on an open chain. The norm is taken
    in float64 with the environment rescaled at each site, so long chains
    neither overflow nor underflow."""
    arrays = []
    for i in range(L):
        if cyclic:
            chil = chir = bond_dim
        else:
            chil = min(bond_dim, phys_dim**i, phys_dim ** (L - i))
            chir = min(bond_dim, phys_dim ** (i + 1),
                       phys_dim ** (L - i - 1))
        arrays.append(rng.standard_normal((chil, phys_dim, chir)))
    if normalize and not cyclic:
        env = np.ones((1, 1))
        log_nrm2 = 0.0
        for A in arrays:
            # two pairwise products, each O(chi^3 p): env @ A, then A
            env = np.tensordot(np.tensordot(env, A, axes=(0, 0)), A,
                               axes=((0, 1), (0, 1)))
            scale = np.linalg.norm(env)
            env = env / scale
            log_nrm2 += math.log(scale)
        log_nrm2 += math.log(env.item())
        f = math.exp(-log_nrm2 / (2 * L))
        arrays = [A * f for A in arrays]
    return arrays


def MPS_rand_state(L, bond_dim, phys_dim=2, normalize=True, cyclic=False,
                   dtype=None, seed=None, trans_invar=False, device=None,
                   **mps_opts):
    """Random MPS with bond dimension ``bond_dim``: standard normal
    entries from ``np.random.default_rng(seed)``. With ``normalize`` every
    tensor is scaled by one factor so that <psi|psi> = 1, the norm taken
    in float64 in log space whatever ``dtype``."""
    rng = np.random.default_rng(seed)
    arrays = _on(_rand_state_arrays(L, bond_dim, phys_dim, normalize,
                                    cyclic, rng), device, _dtype(dtype))
    if not cyclic:
        return _arrays_to_mps(arrays, **mps_opts)
    psi = MatrixProductState([A.permute(0, 2, 1) for A in arrays],
                             shape="lrp", cyclic=True, **mps_opts)
    if normalize:
        psi.normalize()
    return psi


def MPS_product_state(arrays, cyclic=False, dtype=None, device=None,
                      **mps_opts):
    """Product-state MPS from single-site vectors, in ``dtype`` (the
    vectors' own when ``None``)."""
    L = len(arrays)
    mps_arrays = []
    for i, a in enumerate(_on(arrays, device, dtype)):
        a = a.reshape(-1)
        shape = [1] * ((i > 0 or cyclic) + (i < L - 1 or cyclic))
        mps_arrays.append(a.reshape(*shape, a.numel()))
    return MatrixProductState(mps_arrays, shape="lrp", cyclic=cyclic,
                              **mps_opts)


def MPS_computational_state(binary, dtype=None, device=None, **mps_opts):
    """MPS of a computational basis state such as ``"01101"``."""
    if isinstance(binary, (tuple, list)):
        binary = "".join(map(str, binary))
    return MPS_product_state([np.eye(2)[int(b)] for b in binary],
                             dtype=_dtype(dtype), device=device, **mps_opts)


def MPS_zero_state(L, bond_dim=1, phys_dim=2, dtype=None, device=None,
                   **mps_opts):
    """The MPS of all-zero amplitudes (to build into)."""
    device = resolve_device(device)
    arrays = [torch.zeros(
        [bond_dim] * ((i > 0) + (i < L - 1)) + [phys_dim],
        dtype=_dtype(dtype), device=device) for i in range(L)]
    return MatrixProductState(arrays, shape="lrp", **mps_opts)


def MPS_neel_state(L, down_first=False, dtype=None, device=None,
                   **mps_opts):
    """The Néel state ``0101...`` (``1010...`` with ``down_first``)."""
    binary = ("10" if down_first else "01") * L
    return MPS_computational_state(binary[:L], dtype=dtype, device=device,
                                   **mps_opts)


def MPS_rand_computational_state(L, dtype=None, seed=None, device=None,
                                 **mps_opts):
    """A computational basis state drawn from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    binary = "".join(rng.choice(["0", "1"]) for _ in range(L))
    return MPS_computational_state(binary, dtype=dtype, device=device,
                                   **mps_opts)


def MPS_ghz_state(L, dtype=None, device=None, **mps_opts):
    """The GHZ state as a bond-dimension 2 MPS."""
    arrays = []
    for i in range(L):
        if i == 0:
            a = np.eye(2) * 2**-0.5          # (r, p)
        elif i == L - 1:
            a = np.eye(2)                    # (l, p)
        else:
            a = np.zeros((2, 2, 2))          # (l, r, p)
            a[0, 0, 0] = a[1, 1, 1] = 1.0
        arrays.append(a)
    return MatrixProductState(_on(arrays, device, _dtype(dtype)),
                              shape="lrp", **mps_opts)


def MPS_w_state(L, dtype=None, device=None, **mps_opts):
    """The W state as a bond-dimension 2 MPS: the bond says whether the
    excitation has been placed."""
    sq = 1 / math.sqrt(L)
    arrays = []
    for i in range(L):
        if i == 0:
            a = np.zeros((2, 2))
            a[0, 0], a[1, 1] = 1.0, sq
        elif i == L - 1:
            a = np.zeros((2, 2))
            a[0, 1], a[1, 0] = sq, 1.0
        else:
            a = np.zeros((2, 2, 2))
            a[0, 0, 0], a[0, 1, 1], a[1, 1, 0] = 1.0, sq, 1.0
        arrays.append(a)
    return MatrixProductState(_on(arrays, device, _dtype(dtype)),
                              shape="lrp", **mps_opts)


def MPS_sampler(L, dtype=None, seed=None, device=None, **mps_opts):
    """A random computational state."""
    return MPS_rand_computational_state(L, dtype=dtype, seed=seed,
                                        device=device, **mps_opts)


def MPS_COPY(L, phys_dim=2, dtype="float64", device=None, **mps_opts):
    """The MPS of the L-leg COPY (delta) tensor."""
    arrays = []
    for i in range(L):
        shape = [phys_dim] * ((i > 0) + (i < L - 1) + 1)
        x = np.zeros(shape)
        for k in range(phys_dim):
            x[(k,) * len(shape)] = 1.0
        arrays.append(x)
    return MatrixProductState(_on(arrays, device, _dtype(dtype)),
                              **mps_opts)


# ---------------------------------------------------------------------------
# MPO builders
# ---------------------------------------------------------------------------


def _product_mpo(ops, cyclic, device, dtype, **mpo_opts):
    """The bond-dimension 1 MPO of the single-site operators ``ops``."""
    L = len(ops)
    arrays = []
    for i, a in enumerate(_on(ops, device, dtype)):
        d = a.shape[0]
        nb = 2 if cyclic else (i > 0) + (i < L - 1)
        arrays.append(a.reshape(*[1] * nb, d, d))
    return MatrixProductOperator(arrays, shape="lrud", cyclic=cyclic,
                                 **mpo_opts)


def MPO_identity(L, phys_dim=2, dtype=None, sites=None, cyclic=False,
                 device=None, **mpo_opts):
    """The identity MPO."""
    return _product_mpo([np.eye(phys_dim)] * L, cyclic, device,
                        _dtype(dtype), **mpo_opts)


def _like_opts(mpo, mpo_opts):
    mpo_opts.setdefault("device", _tn_device(mpo))
    return dict(upper_ind_id=mpo.upper_ind_id,
                lower_ind_id=mpo.lower_ind_id, site_tag_id=mpo.site_tag_id,
                **mpo_opts)


def MPO_identity_like(mpo, **mpo_opts):
    return MPO_identity(mpo.L, phys_dim=mpo.phys_dim(), dtype=mpo.dtype,
                        **_like_opts(mpo, mpo_opts))


def MPO_zeros(L, phys_dim=2, dtype=None, device=None, **mpo_opts):
    return _product_mpo([np.zeros((phys_dim, phys_dim))] * L, False,
                        device, _dtype(dtype), **mpo_opts)


def MPO_zeros_like(mpo, **mpo_opts):
    return MPO_zeros(mpo.L, phys_dim=mpo.phys_dim(), dtype=mpo.dtype,
                     **_like_opts(mpo, mpo_opts))


def MPO_product_operator(arrays, cyclic=False, dtype=None, device=None,
                         **mpo_opts):
    """The product (bond dimension 1) MPO of single-site operators, in
    ``dtype`` (the operators' own when ``None``)."""
    return _product_mpo(arrays, cyclic, device, dtype, **mpo_opts)


def MPO_rand(L, bond_dim, phys_dim=2, normalize=True, herm=False,
             dtype=None, seed=None, device=None, **mpo_opts):
    """Random MPO, standard normal entries from
    ``np.random.default_rng(seed)`` (real and imaginary parts for a
    complex dtype); with ``normalize`` scaled so that the full contraction
    of ``mpo.H & mpo`` has modulus 1, as quimb_tpu scales it."""
    dtype = _dtype(dtype)
    rng = np.random.default_rng(seed)
    arrays = []
    for i in range(L):
        shape = [bond_dim] * ((i > 0) + (i < L - 1)) + [phys_dim] * 2
        a = rng.standard_normal(shape)
        if dtype.is_complex:
            a = a + 1j * rng.standard_normal(shape)
        if herm:
            a = a + np.conj(np.swapaxes(a, -2, -1))
        arrays.append(a)
    mpo = MatrixProductOperator(_on(arrays, device, dtype), shape="lrud",
                                **mpo_opts)
    if normalize:
        nf = abs(complex((mpo.H.copy() & mpo.copy()).contract(...))) ** 0.5
        mpo.multiply_(1 / nf)
    return mpo


def MPO_rand_herm(L, bond_dim, phys_dim=2, normalize=True, dtype=None,
                  seed=None, device=None, **mpo_opts):
    return MPO_rand(L, bond_dim, phys_dim=phys_dim, normalize=normalize,
                    herm=True, dtype=dtype, seed=seed, device=device,
                    **mpo_opts)


# ---------------------------------------------------------------------------
# SpinHam1D
# ---------------------------------------------------------------------------


class _TermAdder:
    """Lets ``builder[i, j] += (f, 'Z', 'Z')`` work."""

    def __init__(self, terms, nsite):
        self.terms = list(terms) if terms is not None else []
        self.nsite = nsite

    def __iadd__(self, term):
        if len(term) - 1 != self.nsite:
            raise ValueError("wrong number of operators for site spec")
        self.terms.append(term)
        return self

    def __isub__(self, term):
        self.terms.append((-term[0], *term[1:]))
        return self


class SpinHam1D:
    """Nearest-neighbour spin-chain Hamiltonian builder, to an MPO by the
    finite-state-machine construction (open and cyclic chains) or to a
    :class:`~.tebd.LocalHam1D` for TEBD (reference ``SpinHam1D``
    tensor_builder.py:4967). Operators are the labels of
    :func:`quimb_torch.gen.operators._spin_op_np` or matrices; per-site
    terms are set with ``H[i] = ...`` and ``H[i, i + 1] = ...``."""

    def __init__(self, S=1 / 2, cyclic=False):
        self.S = S
        self.cyclic = cyclic
        self.one_site_terms = []
        self.two_site_terms = []
        self.var_one_site_terms = {}
        self.var_two_site_terms = {}

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

    def __getitem__(self, sites):
        if isinstance(sites, Integral):
            return _TermAdder(self.var_one_site_terms.get(sites), 1)
        i, j = sorted(sites)
        if j - i != 1:
            raise NotImplementedError("only nearest-neighbour terms")
        return _TermAdder(self.var_two_site_terms.get((i, j)), 2)

    def __setitem__(self, sites, value):
        terms = value.terms if isinstance(value, _TermAdder) else value
        if isinstance(sites, Integral):
            self.var_one_site_terms[sites] = terms
        else:
            i, j = sorted(sites)
            if j - i != 1:
                raise ValueError("only nearest-neighbour terms")
            self.var_two_site_terms[(i, j)] = terms

    def _op(self, s):
        if isinstance(s, str):
            return _spin_op_np(s, float(self.S))
        return to_host(s)

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

    def _mpo_tensor(self, one_terms, two_terms, left_two_terms=None):
        """The bulk MPO tensor W[D, D, d, d] of the finite-state machine:
        channel 0 carries the identity string, channel D - 1 the finished
        terms (Schur form); ``left_two_terms`` are the terms that end on
        this site."""
        if left_two_terms is None:
            left_two_terms = two_terms
        d = int(2 * self.S + 1)
        D = max(len(two_terms), len(left_two_terms)) + 2
        W = np.zeros((D, D, d, d), dtype=complex)
        I = np.eye(d, dtype=complex)
        W[0, 0] = I
        for k, (factor, s1, _) in enumerate(two_terms):
            W[0, k + 1] = factor * self._op(s1)
        for k, (_, _, s2) in enumerate(left_two_terms):
            W[k + 1, D - 1] = self._op(s2)
        if one_terms:
            W[0, D - 1] = self._sum_one_site(one_terms)
        W[D - 1, D - 1] = I
        return W

    def build_mpo(self, L, upper_ind_id="k{}", lower_ind_id="b{}",
                  site_tag_id="I{}", tags=None, dtype=None, device=None):
        """The MPO (reference tensor_builder.py:5112): each site's tensor
        from its own terms, the first row kept on site 0 and the last
        column on site ``L - 1``; a real site tensor comes out in the real
        counterpart of ``dtype`` (complex128 by default). A cyclic chain
        is the open one closed by a size-1 wrap bond, plus the wrap terms
        as product MPOs by direct sum."""
        ids = dict(upper_ind_id=upper_ind_id, lower_ind_id=lower_ind_id,
                   site_tag_id=site_tag_id)
        if self.cyclic:
            return self._build_mpo_cyclic(L, tags=tags, dtype=dtype,
                                          device=device, **ids)
        dtype = _dtype(dtype, DEFAULT_DTYPE)
        arrays = []
        for i in range(L):
            W = self._mpo_tensor(
                self.var_one_site_terms.get(i, self.one_site_terms),
                self.var_two_site_terms.get((i, i + 1),
                                            self.two_site_terms),
                left_two_terms=self.var_two_site_terms.get(
                    (i - 1, i), self.two_site_terms))
            D = W.shape[0]
            arr = W[0, :] if i == 0 else (W[:, D - 1] if i == L - 1 else W)
            dt = dtype
            if np.allclose(arr.imag, 0):
                arr = arr.real
                dt = dtype.to_real()
            arrays.append((np.ascontiguousarray(arr), dt))
        device = resolve_device(device)
        return MatrixProductOperator(
            [to_device(a, device=device, dtype=dt) for a, dt in arrays],
            shape="lrud", tags=tags, **ids)

    def _build_mpo_cyclic(self, L, tags=None, dtype=None, device=None,
                          **ids):
        obc = SpinHam1D(S=self.S, cyclic=False)
        obc.one_site_terms = list(self.one_site_terms)
        obc.two_site_terms = list(self.two_site_terms)
        obc.var_one_site_terms = dict(self.var_one_site_terms)
        obc.var_two_site_terms = dict(self.var_two_site_terms)
        mpo_obc = obc.build_mpo(L, tags=tags, dtype=dtype, device=device,
                                **ids)
        from .core import _mpo_uniform_arrays

        total = MatrixProductOperator(_mpo_uniform_arrays(mpo_obc),
                                      shape="lrud", cyclic=True, tags=tags,
                                      **ids)
        d = int(2 * self.S + 1)
        for factor, s1, s2 in self.var_two_site_terms.get(
                (L - 1, 0), self.two_site_terms):
            ops = [np.eye(d, dtype=complex) for _ in range(L)]
            ops[L - 1] = factor * self._op(s1)
            ops[0] = self._op(s2)
            term = MPO_product_operator(
                ops, cyclic=True, tags=tags, device=device,
                dtype=_dtype(dtype, DEFAULT_DTYPE), **ids)
            total = total.add_MPO(term)
        return total

    def build_local_ham(self, L=None, **local_ham_1d_opts):
        """The :class:`~.tebd.LocalHam1D` (TEBD) form on ``L`` sites."""
        from .tebd import LocalHam1D

        H1s, H2s = {}, {}
        if self.two_site_terms:
            H2s[None] = self._sum_two_site(self.two_site_terms)
        for (i, j), terms in self.var_two_site_terms.items():
            H2s[(i, j)] = self._sum_two_site(terms)
        if self.one_site_terms:
            H1s[None] = self._sum_one_site(self.one_site_terms)
        for i, terms in self.var_one_site_terms.items():
            H1s[i] = self._sum_one_site(terms)
        return LocalHam1D(L=L, H2=H2s, H1=H1s if H1s else None,
                          cyclic=self.cyclic, **local_ham_1d_opts)


# ---------------------------------------------------------------------------
# named Hamiltonians
# ---------------------------------------------------------------------------


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


def MPO_ham_heis(L, j=1.0, bz=0.0, S=1 / 2, cyclic=False, **mpo_opts):
    """Heisenberg MPO (reference tensor_builder.py:5498)."""
    return _ham_heis_builder(j, bz, S, cyclic).build_mpo(L, **mpo_opts)


def ham_1d_heis(L=None, j=1.0, bz=0.0, S=1 / 2, cyclic=False,
                **local_ham_1d_opts):
    """Heisenberg Hamiltonian as a :class:`~.tebd.LocalHam1D`."""
    return _ham_heis_builder(j, bz, S, cyclic).build_local_ham(
        L, **local_ham_1d_opts)


def _jxy(j):
    try:
        jx, jy = j
    except (TypeError, ValueError):
        jx = jy = j
    return jx, jy


def MPO_ham_XY(L, j=1.0, bz=0.0, S=1 / 2, cyclic=False, **mpo_opts):
    """XY model MPO: the Heisenberg builder with ``jz = 0``."""
    return MPO_ham_heis(L, j=(*_jxy(j), 0.0), bz=bz, S=S, cyclic=cyclic,
                        **mpo_opts)


def ham_1d_XY(L=None, j=1.0, bz=0.0, S=1 / 2, cyclic=False, **opts):
    """XY model: the Heisenberg builder with ``jz = 0``."""
    return ham_1d_heis(L, j=(*_jxy(j), 0.0), bz=bz, S=S, cyclic=cyclic,
                       **opts)


def _ham_ising_builder(j=1.0, bx=0.0, S=1 / 2, cyclic=False):
    H = SpinHam1D(S=S, cyclic=cyclic)
    H += 4 * j, "Z", "Z"
    H -= 2 * bx, "X"
    return H


def MPO_ham_ising(L, j=4.0, bx=2.0, S=1 / 2, cyclic=False, **mpo_opts):
    """Transverse-field Ising MPO, ``j/4 ΣZZ − bx/2 ΣX`` in spin
    operators (quimb's Pauli-style ``j`` and ``bx``)."""
    return _ham_ising_builder(j / 4, bx / 2, S, cyclic).build_mpo(
        L, **mpo_opts)


def ham_1d_ising(L=None, j=4.0, bx=2.0, S=1 / 2, cyclic=False, **opts):
    """Transverse-field Ising model as a :class:`~.tebd.LocalHam1D`."""
    return _ham_ising_builder(j / 4, bx / 2, S, cyclic).build_local_ham(
        L, **opts)


def MPO_ham_XXZ(L, delta, jxy=1.0, S=1 / 2, cyclic=False, **mpo_opts):
    """XXZ model MPO: ``jxy (XX + YY) + delta ZZ``."""
    return MPO_ham_heis(L, j=(*_jxy(jxy), delta), S=S, cyclic=cyclic,
                        **mpo_opts)


def ham_1d_XXZ(L=None, delta=None, jxy=1.0, S=1 / 2, cyclic=False,
               **opts):
    """XXZ model: ``jxy (XX + YY) + delta ZZ``."""
    if delta is None:
        raise ValueError("must specify delta")
    return ham_1d_heis(L, j=(*_jxy(jxy), delta), S=S, cyclic=cyclic,
                       **opts)


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


def MPO_ham_bilinear_biquadratic(L=None, theta=0, S=1 / 2, cyclic=False,
                                 compress=True, **mpo_opts):
    """Bilinear-biquadratic model MPO, compressed at cutoff 1e-12."""
    mpo = _ham_bilinear_biquadratic_builder(
        theta, S=S, cyclic=cyclic).build_mpo(L, **mpo_opts)
    if compress:
        mpo.compress(cutoff=1e-12)
    return mpo


def ham_1d_bilinear_biquadratic(L=None, theta=0, S=1 / 2, cyclic=False,
                                **opts):
    """Bilinear-biquadratic spin model as a :class:`~.tebd.LocalHam1D`."""
    return _ham_bilinear_biquadratic_builder(
        theta, S=S, cyclic=cyclic).build_local_ham(L, **opts)


__all__ = [
    "MPO_ham_XXZ", "MPO_ham_XY", "MPO_ham_bilinear_biquadratic",
    "MPO_ham_heis", "MPO_ham_ising", "MPO_identity", "MPO_identity_like",
    "MPO_product_operator", "MPO_rand", "MPO_rand_herm", "MPO_zeros",
    "MPO_zeros_like", "MPS_COPY", "MPS_computational_state",
    "MPS_ghz_state", "MPS_neel_state", "MPS_product_state",
    "MPS_rand_computational_state", "MPS_rand_state", "MPS_sampler",
    "MPS_w_state", "MPS_zero_state", "SpinHam1D",
    "ham_1d_bilinear_biquadratic", "ham_1d_heis", "ham_1d_ising",
    "ham_1d_XXZ", "ham_1d_XY",
]
