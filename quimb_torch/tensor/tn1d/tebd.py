"""TEBD: time-evolving block decimation for 1D chains and rings.

Port of ``quimb_tpu/tensor/tn1d/tebd.py``. ``LocalHam1D`` holds the
nearest-neighbour terms as host numpy arrays; ``TEBD`` takes a
:class:`~.core.MatrixProductState` and applies second- or fourth-order
Suzuki-Trotter steps of their exponentials to its uniform arrays (tensors
``(l, p, r)``, the ends padded with size-1 bonds); ``.pt`` gives the state
back as a :class:`~.core.MatrixProductState`.

Two paths apply a parity sweep (all even, or all odd, bonds):

- the fused path, when ``split_opts["max_bond"]`` is set: the state is
  held as a zero-padded stack of right-canonical B-form tensors
  ``Bs (L, chi, d, chi)`` with the Schmidt weights ``ls (L + 1, chi)``,
  and one sweep is one batched gate + SVD + masked truncation over its
  disjoint bonds (Hastings' inverse-free update), gathered from the stack
  and scattered back by an index tensor, with no host read of its own
  (``entropy`` and ``trunc_err`` read the device);
- the sequential path otherwise: each bond in turn is QR-reduced, gated
  and split by a truncated SVD, as quimb_tpu's ``gate_split`` does.

A ring (a cyclic :class:`LocalHam1D`) evolves a cyclic MPS on the
sequential path: its odd sweep also gates the wrap bond ``(L - 1, 0)``,
and each bond is the MPS object's own reduce-split move
(:meth:`~.core.MatrixProductState.gate_split_`), as in quimb_tpu.

``TEBD.shard_onto(mesh)`` splits the fused path's stacks over the ranks of
a mesh of :mod:`quimb_torch.parallel`: each rank holds a contiguous block
of sites and the weights at its edges, and updates the bonds whose left
site it owns; a bond that straddles two ranks takes its right site from
the neighbour and sends the updated site and weight back (two all-gathers
a parity sweep).
"""

import numpy as np
import torch

from ...ops import decomp
from ...ops.backend import complex_dtype, resolve_device, to_device, to_host
from ...parallel.mesh import _all_gather, _all_reduce, _broadcast
from ...utils import continuous_progbar
from .core import _arrays_to_mps, _mps_uniform_arrays, expec_TN_1D
from .dmrg import _right_canonize_step


def _as_real(x):
    """A real view of ``x`` (complex entries as pairs)."""
    return torch.view_as_real(x) if x.is_complex() else x


def _from_real(flat, like):
    """The entries of ``_as_real(like)`` in ``flat`` -> a tensor like
    ``like``."""
    x = flat.reshape(_as_real(like).shape)
    return torch.view_as_complex(x.contiguous()) if like.is_complex() else x


def _expm_herm(H, factor):
    """``expm(factor * H)`` for (a batch of) hermitian ``H`` via ``eigh``,
    on ``H``'s device."""
    w, V = torch.linalg.eigh(H)
    phases = torch.exp(factor * w)
    dt = torch.promote_types(V.dtype, phases.dtype)
    V = V.to(dt)
    return (V * phases.to(dt)[..., None, :]) @ decomp.dag(V)


class LocalHam1D:
    """A sum of nearest-neighbour (and single-site) terms.

    ``H2`` maps ``(i, i + 1)`` (or ``None`` for the default) to d² × d²
    arrays; ``H1`` maps ``i`` (or ``None``) to d × d arrays. Single-site
    terms are absorbed into the neighbouring two-site terms: half into
    each, all of it at a chain end. The terms are host numpy arrays."""

    def __init__(self, L, H2, H1=None, cyclic=False):
        self.L = L
        self.cyclic = cyclic

        if hasattr(H2, "shape"):
            H2 = {None: H2}
        H2 = dict(H2 or {})
        if H1 is not None and hasattr(H1, "shape"):
            H1 = {None: H1}
        H1 = dict(H1 or {})

        # for cyclic chains the wrap term is stored as (L - 1, 0)
        self.terms = {}
        default2 = H2.get(None)
        pairs = [(i, i + 1) for i in range(L - 1)]
        if cyclic:
            pairs.append((L - 1, 0))
        for pair in pairs:
            h = H2.get(pair, default2)
            if h is not None:
                self.terms[pair] = to_host(h)

        default1 = H1.get(None)
        for i in range(L):
            h1 = H1.get(i, default1)
            if h1 is None:
                continue
            h1 = to_host(h1)
            I = np.eye(h1.shape[0])
            if cyclic:
                # every site borders two bonds on a ring
                coeff_right = coeff_left = 0.5
                right_pair = (i, i + 1) if i < L - 1 else (L - 1, 0)
                left_pair = (i - 1, i) if i > 0 else (L - 1, 0)
            else:
                # an end site gives its full weight to its one bond
                coeff_right = 1.0 if i == 0 else (0.5 if i < L - 1 else 0.0)
                coeff_left = 1.0 if i == L - 1 else (0.5 if i > 0 else 0.0)
                right_pair = (i, i + 1)
                left_pair = (i - 1, i)
            if coeff_right and right_pair in self.terms:
                self.terms[right_pair] = self.terms[right_pair] + \
                    coeff_right * np.kron(h1, I)
            if coeff_left and left_pair in self.terms:
                self.terms[left_pair] = self.terms[left_pair] + \
                    coeff_left * np.kron(I, h1)

        self._gate_cache = {}

    def get_term(self, where):
        where = tuple(where)
        try:
            return self.terms[where]
        except KeyError:
            pass
        try:
            return self.terms[tuple(sorted(where))]
        except KeyError:
            pass
        # stored under the reversed orientation: swap the two factors
        h = self.terms[where[::-1]]
        d = int(round(h.shape[0] ** 0.5))
        return np.reshape(np.transpose(np.reshape(h, (d, d, d, d)),
                                       (1, 0, 3, 2)), (d * d, d * d))

    def __call__(self, where):
        return self.get_term(where)

    def get_gate_expm(self, where, x, device=None):
        """Cached ``expm(x * H_where)`` on ``device`` (the GPU unless
        named), in complex128."""
        device = resolve_device(device)
        key = (tuple(sorted(where)), complex(x), device)
        try:
            return self._gate_cache[key]
        except KeyError:
            H = to_device(self.get_term(where), device=device,
                          dtype=torch.complex128)
            U = self._gate_cache[key] = _expm_herm(H, complex(x))
            return U

    def mean_norm(self):
        """Mean Frobenius norm of the terms."""
        return float(np.mean([np.linalg.norm(h)
                              for h in self.terms.values()]))

    def build_mpo_propagator_trotterized(self, x, max_bond=None,
                                         cutoff=1e-12, device=None,
                                         **mpo_opts):
        """The first-order Trotterized propagator ``prod_b exp(x H_b)`` as
        an MPO on ``device`` (reference ``LocalHam1D`` propagator
        tn1d/tebd.py:100): the even bonds' gates, then the odd ones',
        applied to an identity MPO by reduce-split."""
        from ..gating import tensor_network_gate_inds
        from .builders import MPO_identity

        mpo = MPO_identity(self.L, dtype=torch.complex128, device=device,
                           **mpo_opts)
        for parity in (0, 1):
            for i in range(parity, self.L - 1, 2):
                U = self.get_gate_expm((i, i + 1), x, device=device)
                tensor_network_gate_inds(
                    mpo, U, (mpo.upper_ind(i), mpo.upper_ind(i + 1)),
                    contract="reduce-split", inplace=True,
                    max_bond=max_bond, cutoff=cutoff,
                )
        return mpo

    def __repr__(self):
        return f"<LocalHam1D(L={self.L}, cyclic={self.cyclic})>"


# -- the fused path -----------------------------------------------------------


def _bform_gate_split_batch(B1s, B2s, l_l, Us, max_bond, cutoff):
    """Apply two-site gates to a batch of disjoint bonds held in
    right-canonical B-form and re-split them with a bounded bond:
    Hastings' inverse-free update. The optimal environment-weighted
    truncation comes from the SVD of ``theta = lambda_left . Phi`` (``Phi``
    the gated pair), and the new site tensors need no inverse of a Schmidt
    weight::

        B2' = VH                  (exactly right-canonical)
        B1' = Phi @ VH^dagger     (right-canonical in exact arithmetic)

    B1s, B2s: (m, chi, d, chi); l_l: (m, chi) real; Us: (m, d*d, d*d).
    Returns the updated (B1s, B2s), the new normalised weights (m, chi)
    and the discarded weight of each bond (m,)."""
    m, chi, d, _ = B1s.shape
    ph = torch.einsum("mlpc,mcqr->mlpqr", B1s, B2s)
    ph = torch.einsum("muvpq,mlpqr->mluvr", Us.reshape(m, d, d, d, d), ph)
    # theta = ll . Phi: the physical wavefunction across the bond
    th = ph * l_l[:, :, None, None, None]
    Uf, s_full, VHf = decomp.safe_svd(th.reshape(m, chi * d, d * chi))
    _, s, VH, rank = decomp._truncate_mask_absorb(
        Uf, s_full, VHf, max_bond=max_bond, cutoff=cutoff, cutoff_mode=4,
        renorm=0, absorb=None,
    )
    # the discarded weight summed directly over the dropped values: exact
    # in float32, unlike total^2 - kept^2, whose cancellation is noise
    sp_full = s_full * s_full
    dropped = torch.arange(s_full.shape[-1], device=s_full.device) \
        >= rank[:, None]
    drop = torch.sum(torch.where(dropped, sp_full, 0.0), dim=-1)
    tot2 = torch.sum(sp_full, dim=-1)
    err = torch.sqrt(drop / torch.where(tot2 > 0, tot2, 1.0))
    # dropped values below a few epsilons of the spectrum's norm are the
    # SVD's noise, not truncation
    noise_floor = 8 * torch.finfo(s_full.dtype).eps
    err = torch.where(err > noise_floor, err, 0.0)
    nrm = torch.linalg.norm(s, dim=-1)
    nrm = torch.where(nrm > 0, nrm, 1.0)
    s_n = s / nrm[:, None]
    B2n = VH.reshape(m, chi, d, chi)
    # renormalised by the kept weight, so that the state stays normalised
    B1n = (ph.reshape(m, chi * d, d * chi) @ decomp.dag(VH)).reshape(
        m, chi, d, chi) / nrm[:, None, None, None]
    return B1n, B2n, s_n, err


def _fused_parity_update(Bs, ls, Us, idx, max_bond, cutoff):
    """Gather the bonds ``(idx, idx + 1)`` of one parity, gate and split
    them as one batch, and scatter the results back into ``Bs`` and ``ls``
    (in place: the bonds are disjoint). Returns the summed discarded
    weight, on the device."""
    B1n, B2n, lcn, errs = _bform_gate_split_batch(
        Bs[idx], Bs[idx + 1], ls[idx], Us, max_bond=max_bond, cutoff=cutoff)
    Bs[idx] = B1n
    Bs[idx + 1] = B2n
    ls[idx + 1] = lcn
    return torch.sum(errs)


def _right_canonize(As):
    """Right-canonical copy of a list state by LQ from the right end, the
    norm held in the first tensor."""
    As = list(As)
    for i in range(len(As) - 1, 0, -1):
        As[i - 1], As[i] = _right_canonize_step(As[i - 1], As[i])
    return As


def _schmidt_sweep(arrays, chi=None):
    """One left-to-right SVD sweep of the carry over a right-canonical,
    normalised list state of host arrays ``A_i``. Returns the Schmidt
    weights, an array (L + 1, chi) whose chain ends hold ``[1, 0, ...]``
    (``chi`` defaults to the largest bond), and the same state in the bond
    bases of those weights, ``B_i = VH_{i-1} A_i VH_i^dagger``: still
    right-canonical, with no weight inverted. (quimb_tpu keeps ``A_i`` as
    it is, so its first sweeps weight each bond in the wrong basis unless
    the state is a product state.)"""
    L = len(arrays)
    d = arrays[0].shape[1]
    if chi is None:
        chi = max(a.shape[2] for a in arrays)
    ls = np.zeros((L + 1, chi), dtype=np.zeros(1, arrays[0].dtype).real.dtype)
    ls[0, 0] = ls[L, 0] = 1.0
    Bs, carry, B = [], arrays[0], arrays[0]
    for i in range(L - 1):
        l, _, r = carry.shape
        _, s, VH = np.linalg.svd(carry.reshape(l * d, r), full_matrices=False)
        k = min(len(s), chi)
        s, VH = s[:k], VH[:k, :]
        snrm = np.linalg.norm(s)
        ls[i + 1, :k] = s / (snrm if snrm > 0 else 1.0)
        Bs.append(np.einsum("lpr,kr->lpk", B, VH.conj()))
        B = np.einsum("kr,rpc->kpc", VH, arrays[i + 1])
        carry = s[:, None, None] * B
    Bs.append(B)
    return ls, Bs


def _mps_to_vidal(psi, chi):
    """A list state -> the zero-padded right-canonical B-form stacks
    ``Bs (L, chi, d, chi)`` in its dtype and ``ls (L + 1, chi)`` in the
    matching real dtype, on its device. ``psi = B_0 B_1 ... B_{L-1}`` with
    no weights in the product, each bond in the basis of its weights
    ``ls``: the state is right-canonised by LQ on its device, then one
    host SVD sweep of the carry gives the weights and the bond bases
    (set-up, not the hot path)."""
    device = psi[0].device
    arrays = [to_host(A) for A in _right_canonize(psi)]
    nrm0 = np.linalg.norm(arrays[0])
    if nrm0 > 0:
        arrays[0] = arrays[0] / nrm0
    L, d = len(arrays), arrays[0].shape[1]
    if max(max(a.shape[0], a.shape[2]) for a in arrays) > chi:
        raise ValueError(f"the state has a bond above max_bond={chi}")
    ls, arrays = _schmidt_sweep(arrays, chi)
    Bs = np.zeros((L, chi, d, chi), dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        l, _, r = a.shape
        Bs[i, :l, :, :r] = a
    return to_device(Bs, device=device), to_device(ls, device=device)


def _vidal_to_mps(Bs, ls):
    """The B-form stacks -> a list state, each bond cut to the indices
    whose weight is nonzero (a float32 mask need not keep a prefix)."""
    ls_host = to_host(ls)
    keep = [torch.as_tensor(np.flatnonzero(w > 0), device=Bs.device)
            for w in ls_host]
    return [Bs[i].index_select(0, keep[i]).index_select(2, keep[i + 1])
            for i in range(Bs.shape[0])]


# -- the sequential path ------------------------------------------------------


def _svd_split_both(x, max_bond=None, cutoff=1e-10, cutoff_mode="rsum2",
                    renorm=0):
    """Truncated SVD ``x ~= left @ right``, the singular values' square
    roots absorbed on both sides, the rank resolved on the host as
    quimb_tpu's ``svd_truncated`` does. Returns ``(left, right, error)``,
    ``error`` the norm of the dropped singular values (0.0 when none)."""
    cutoff_mode = decomp.CUTOFF_MODE_MAP[cutoff_mode]
    U, s, VH = decomp.safe_svd(x)
    d = s.shape[-1]
    if (cutoff is not None and cutoff > 0) or renorm:
        _, s_k, _, rank = decomp._truncate_mask_absorb(
            U, s, VH, max_bond=max_bond, cutoff=cutoff or 0.0,
            cutoff_mode=cutoff_mode, renorm=int(renorm), absorb=None)
        n = int(rank)
    else:
        n = min(max_bond, d) if max_bond and max_bond > 0 else d
        s_k = s
    error = float(torch.linalg.norm(s[n:])) if n < d else 0.0
    sq = torch.sqrt(s_k[:n])
    return decomp.rdmul(U[:, :n], sq), decomp.ldmul(sq, VH[:n]), error


def _gate_split(As, U, i, **split_opts):
    """quimb_tpu's reduce-split move on sites ``(i, i + 1)`` of the list
    state ``As``, in place: QR each site towards the bond, gate the two
    small cores, split them back by a truncated SVD with ``absorb="both"``
    and absorb the factors into the isometries. Returns the split's
    error."""
    A0, A1 = As[i], As[i + 1]
    l, d0, c = A0.shape
    _, d1, r = A1.shape
    Q0, _, R0 = decomp.qr_stabilized(A0.reshape(l, d0 * c))
    Q1, _, R1 = decomp.qr_stabilized(A1.permute(2, 1, 0).reshape(r, d1 * c))
    k0, k1 = Q0.shape[1], Q1.shape[1]
    theta = torch.einsum("uvpq,apc,bqc->aubv", U.reshape(d0, d1, d0, d1),
                         R0.reshape(k0, d0, c), R1.reshape(k1, d1, c))
    left, right, error = _svd_split_both(
        theta.reshape(k0 * d0, k1 * d1), **split_opts)
    n = left.shape[1]
    As[i] = torch.einsum("ak,kpn->apn", Q0, left.reshape(k0, d0, n))
    As[i + 1] = torch.einsum("rk,nkq->nqr", Q1, right.reshape(n, k1, d1))
    return error


def _normalize(As):
    """Scale the first tensor of the list state so that ⟨ψ|ψ⟩ = 1."""
    env = torch.ones((1, 1), dtype=As[0].dtype, device=As[0].device)
    for A in As:
        env = torch.einsum("ab,apx,bpy->xy", env, torch.conj(A), A)
    As[0] = As[0] / torch.sqrt(env.real.reshape(()))


# -- TEBD ---------------------------------------------------------------------


class TEBD:
    """Time-evolving block decimation on an open chain.

    Parameters
    ----------
    p0 : MatrixProductState
        Initial state (copied), e.g. from :func:`MPS_neel_state`; cyclic
        when ``H`` is. Its device runs the evolution. For real time a real
        state is promoted to the complex dtype of its precision.
    H : LocalHam1D or array or dict
        The local Hamiltonian.
    dt : float, optional
        Fixed time step. Exclusive with ``tol``.
    tol : float, optional
        Choose ``dt`` so that the Trotter error estimate stays below
        ``tol`` over the evolution.
    t0 : float, optional
        Initial time.
    imag : bool, optional
        Imaginary time evolution, with renormalisation.
    split_opts : dict, optional
        Options of the splits: ``max_bond`` (which selects the fused path),
        ``cutoff`` (default 1e-10), and on the sequential path also
        ``cutoff_mode`` (default ``"rsum2"``) and ``renorm``.
    fused : bool, optional
        Take the fused path whenever ``max_bond`` is set.
    """

    #: tolerance for considering the target time reached
    TARGET_TOL = 1e-13

    def __init__(self, p0, H, dt=None, tol=None, t0=0.0, imag=False,
                 split_opts=None, progbar=True, fused=True):
        self.L = p0.L
        self.imag = imag
        self._like = p0
        if not isinstance(H, LocalHam1D):
            H = LocalHam1D(self.L, H)
        self.H = H
        self._dtype = p0.dtype
        if not imag and not self._dtype.is_complex:
            self._dtype = complex_dtype(self._dtype)
        if H.cyclic:
            if not p0.cyclic:
                raise ValueError("a ring Hamiltonian evolves a cyclic MPS")
            # the ring keeps its MPS object (sequential path only)
            self._pt = p0.astype(self._dtype)
            self._device = next(iter(p0)).data.device
        else:
            arrays = _mps_uniform_arrays(p0)
            self._pt = [A.to(self._dtype, copy=True) for A in arrays]
            self._device = arrays[0].device
        self.fused = fused
        self._vidal = None
        self._err_pending = []
        self._dt = dt
        self.tol = tol
        self.t = float(t0)
        self.split_opts = dict(split_opts or {})
        self.split_opts.setdefault("cutoff", 1e-10)
        self.progbar = progbar
        self._err = 0.0
        self._trunc_err = 0.0
        self._ham_norm = self.H.mean_norm()
        self.taus = []
        self._U_cache = {}
        self._idx = {}
        self._shard = None

    @property
    def pt(self):
        """The current state, a :class:`MatrixProductState` with the start
        state's index and tag ids; taken out of the fused B-form, with its
        zero padding cut, if that is active; on a ring, the evolving cyclic
        MPS itself."""
        if self.H.cyclic:
            return self._pt
        return _arrays_to_mps(self._arrays(), like=self._like)

    @pt.setter
    def pt(self, value):
        if self.H.cyclic:
            self._pt = value.astype(self._dtype)
        else:
            self._pt = [A.to(self._dtype)
                        for A in _mps_uniform_arrays(value)]
        self._vidal = None

    def _arrays(self):
        """The state's uniform arrays, out of the fused form if active."""
        self._flush_err()
        if self._vidal is not None:
            self._pt = _vidal_to_mps(*self._gathered_vidal())
            self._vidal = None
        return self._pt

    def _flush_err(self):
        if self._err_pending:
            total = torch.sum(torch.stack(self._err_pending))
            if self._shard is not None:
                total = _all_reduce(total, self._shard[0])
            self._trunc_err += float(total)
            self._err_pending = []

    @property
    def err(self):
        """Estimated accumulated Trotter error, ``sum_steps |H|_mean *
        dt**(order + 1)`` (quimb's ``TEBD.err``); the sequential path adds
        each split's error to it, as quimb_tpu does. The discarded Schmidt
        weight of the fused path is :attr:`trunc_err`."""
        return self._err

    @err.setter
    def err(self, value):
        self._err = float(value)

    @property
    def trunc_err(self):
        """Accumulated discarded Schmidt weight of the fused path's bond
        updates (one host sync for the sweeps since the last read)."""
        self._flush_err()
        return self._trunc_err

    @trunc_err.setter
    def trunc_err(self, value):
        self._trunc_err = float(value)
        self._err_pending = []

    def schmidt_values(self, i):
        """Squared Schmidt values across the bond left of site ``i``,
        descending. From the fused weights when those are active: O(chi),
        no state taken out."""
        if self._vidal is not None:
            s = to_host(self._weights(i)).astype(np.float64)
            return np.sort(s[s > 0])[::-1] ** 2
        if self.H.cyclic:
            return to_host(self._pt.schmidt_values(i))
        arrays = [to_host(A) for A in _right_canonize(self._pt)]
        arrays[0] = arrays[0] / np.linalg.norm(arrays[0])
        s = _schmidt_sweep(arrays)[0][i].astype(np.float64)
        return np.sort(s[s > 0])[::-1] ** 2

    def entropy(self, i=None):
        """Von Neumann entanglement entropy, in bits, across the bond left
        of site ``i`` (default: the half chain)."""
        if i is None:
            i = self.L // 2
        p = np.asarray(self.schmidt_values(i), dtype=np.float64)
        p = p[p > 1e-300]
        p = p / p.sum()
        return float(-(p * np.log2(p)).sum())

    def _fused_applicable(self):
        return (self.fused and not self.H.cyclic and self.L >= 4
                and self.split_opts.get("max_bond") is not None)

    def _ensure_vidal(self):
        """The fused path's stacks ``(Bs, ls)``; under :meth:`shard_onto`
        this rank's block: ``Bs[lo:hi]`` and ``ls[lo:hi + 1]``."""
        if self._vidal is None:
            self._vidal = self._own_block(_mps_to_vidal(
                self._pt, int(self.split_opts["max_bond"])))
            self._pt = None
        return self._vidal

    # -- the sharded fused path ----------------------------------------------

    def shard_onto(self, mesh, axis=None):
        """Split the fused path's stacks over the ranks of ``mesh`` (a
        ``DeviceMesh`` of :mod:`quimb_torch.parallel`) along its axis
        ``axis`` (its first by default): each rank holds a contiguous block
        of the chain's sites, with the Schmidt weights at both its edges,
        and a parity sweep updates the bonds whose left site it owns as one
        batch. For a bond that straddles two ranks the right site comes
        from the neighbour (an all-gather of every block's first site) and
        the updated site and weight go back (an all-gather of the
        outgoing ones). The discarded weight is summed by an all-reduce
        when read; :attr:`pt` gathers the blocks. Every rank calls each
        method with the same arguments; a ring, or a run without
        ``max_bond``, evolves replicated on every rank."""
        from ...parallel.mesh import mesh_device

        vidal = self._gathered_vidal() if self._vidal is not None else None
        self._flush_err()
        axis = mesh.mesh_dim_names[0] if axis is None else axis
        group, p = mesh.get_group(axis), mesh.size(
            mesh.mesh_dim_names.index(axis))
        if self.L < p:
            raise ValueError(f"a chain of {self.L} sites cannot be split "
                             f"over {p} ranks")
        if mesh_device(mesh) != torch.device(self._device):
            raise ValueError(f"the mesh's rank is on {mesh_device(mesh)}, "
                             f"the state on {self._device}")
        edges = np.cumsum([0] + [len(b) for b in np.array_split(
            np.arange(self.L), p)])
        self._shard = (group, p, mesh.get_local_rank(axis), edges)
        self._idx = {}
        if vidal is not None:
            self._vidal = self._own_block(vidal)
        return self

    def _own_block(self, vidal):
        if self._shard is None:
            return vidal
        _, _, r, edges = self._shard
        Bs, ls = vidal
        lo, hi = edges[r], edges[r + 1]
        return Bs[lo:hi].clone(), ls[lo:hi + 1].clone()

    def _gathered_vidal(self):
        """The whole stacks: every rank's block, gathered (zero-padded to
        the largest block for the all-gather)."""
        if self._shard is None:
            return self._vidal
        group, p, _, edges = self._shard
        Bs, ls = self._vidal
        nb = int(np.max(np.diff(edges)))
        Bp = Bs.new_zeros((nb, *Bs.shape[1:]))
        Bp[:Bs.shape[0]] = Bs
        lp = ls.new_zeros((nb + 1, ls.shape[1]))
        lp[:ls.shape[0]] = ls
        Bg, lg = _all_gather(Bp, group), _all_gather(lp, group)
        sizes = np.diff(edges)
        return (torch.cat([B[:n] for B, n in zip(Bg, sizes)]),
                torch.cat([lw[:n] for lw, n in zip(lg, sizes)]
                          + [lg[-1][sizes[-1]][None]]))

    def _weights(self, i):
        """The Schmidt weights ``ls[i]``: on a sharded run, the first rank
        that holds them broadcasts them."""
        if self._shard is None:
            return self._vidal[1][i]
        group, _, r, edges = self._shard
        owner = int(np.searchsorted(edges, i, side="right")) - 1
        owner = min(owner, len(edges) - 2)
        ls = self._vidal[1]
        w = ls[i - edges[r]].clone() if r == owner else ls.new_empty(
            ls.shape[1])
        return _broadcast(w, group, src=owner)

    def _sharded_sweep(self, parity, dt_frac):
        """One parity sweep of this rank's bonds, the straddling bond's
        right site and weight exchanged with the neighbour."""
        group, p, r, edges = self._shard
        Bs, ls = self._vidal
        lo, hi = int(edges[r]), int(edges[r + 1])
        n = hi - lo
        own = [i for i in range(lo, min(hi, self.L - 1))
               if (i - parity) % 2 == 0]
        straddles = [(int(edges[k + 1]) - 1 - parity) % 2 == 0
                     for k in range(p - 1)]
        firsts = _all_gather(Bs[0], group)
        if r < p - 1 and straddles[r]:
            Bs = torch.cat([Bs, firsts[r + 1][None]])
        if own:
            try:
                idx = self._idx[parity]
            except KeyError:
                idx = self._idx[parity] = torch.tensor(
                    [i - lo for i in own], device=self._device)
            Us = self._get_gates([(i, i + 1) for i in own],
                                 dt_frac * self._dt)
            err = _fused_parity_update(
                Bs, ls, Us, idx, max_bond=int(self.split_opts["max_bond"]),
                cutoff=self.split_opts.get("cutoff", 1e-10))
        else:
            err = ls.new_zeros(())
        self._err_pending.append(err)
        # the straddling bond's right site and weight go back
        out = torch.cat([_as_real(Bs[n]).reshape(-1), ls[n]]) \
            if r < p - 1 and straddles[r] else \
            ls.new_zeros(_as_real(Bs[0]).numel() + ls.shape[1])
        back = _all_gather(out, group)
        Bs = Bs[:n]
        if r > 0 and straddles[r - 1]:
            cut = _as_real(Bs[0]).numel()
            Bs[0] = _from_real(back[r - 1][:cut], Bs[0])
            ls[0] = back[r - 1][cut:]
        self._vidal = (Bs, ls)

    def _pair_index(self, parity):
        try:
            return self._idx[parity]
        except KeyError:
            idx = self._idx[parity] = torch.arange(
                parity, self.L - 1, 2, device=self._device)
            return idx

    def _fused_sweep(self, parity, dt_frac):
        """One parity sweep as one batched gate + split of its bonds."""
        Bs, ls = self._ensure_vidal()
        if self._shard is not None:
            self._sharded_sweep(parity, dt_frac)
            return
        pairs = [(i, i + 1) for i in range(parity, self.L - 1, 2)]
        Us = self._get_gates(pairs, dt_frac * self._dt)
        self._err_pending.append(_fused_parity_update(
            Bs, ls, Us, self._pair_index(parity),
            max_bond=int(self.split_opts["max_bond"]),
            cutoff=self.split_opts.get("cutoff", 1e-10),
        ))

    @property
    def dt(self):
        return self._dt

    @dt.setter
    def dt(self, dt):
        self._dt = dt

    def choose_time_step(self, tol, T, order):
        """The Trotter error is ``~ (T / dt) * |H|_mean * dt^(order + 1)``;
        invert it for dt."""
        return (tol / (T * self._ham_norm)) ** (1 / order)

    def _get_gates(self, pairs, dt_frac):
        """The gates ``expm(-i dt_frac H_b)`` (``expm(-dt_frac H_b)`` in
        imaginary time) of ``pairs``, stacked (m, d², d²) in the state's
        dtype on its device, cached by the pairs and the complex factor.
        Computed in complex128 (float64 for a real state) and cast."""
        factor = -dt_frac if self.imag else (-1j * dt_frac)
        key = (tuple(pairs), complex(factor))
        try:
            return self._U_cache[key]
        except KeyError:
            pass
        Hs = np.stack([self.H.get_term(p) for p in pairs])
        if not self._dtype.is_complex:
            if np.any(np.imag(Hs) != 0):
                raise ValueError("a complex Hamiltonian needs a complex "
                                 "state")
            Hs = np.real(Hs)
        Hs = to_device(Hs, device=self._device, dtype=torch.complex128
                       if self._dtype.is_complex else torch.float64)
        # a real state evolves in imaginary time only: ``factor`` is real
        Us = self._U_cache[key] = _expm_herm(Hs, factor).to(self._dtype)
        return Us

    def sweep(self, direction, dt_frac, dt=None, queue=False):
        """Apply the gates of every even (``"right"``) or odd (``"left"``)
        bond for a time ``dt_frac * dt``, with ``dt`` the engine's unless
        given; on a ring the odd sweep also gates the wrap bond ``(L - 1,
        0)``. ``queue`` is accepted and ignored, as quimb_tpu ignores
        it."""
        if dt is not None:
            dt_frac *= dt / self._dt
        parity = {"right": 0, "left": 1}.get(direction)
        if parity is None:
            raise ValueError(f"bad direction {direction}")
        if self._fused_applicable():
            self._fused_sweep(parity, dt_frac)
            return
        if self.H.cyclic:
            self._ring_sweep(parity, dt_frac)
            return
        As = list(self._arrays())
        for i in range(parity, self.L - 1, 2):
            U = self._get_gates([(i, i + 1)], dt_frac * self._dt)[0]
            self._err += _gate_split(As, U, i, **self.split_opts)
        if self.imag:
            _normalize(As)
        self._pt = As

    def _ring_sweep(self, parity, dt_frac):
        """One parity sweep of a ring, bond by bond on the cyclic MPS;
        each split's error is added to :attr:`err`."""
        pairs = [(i, i + 1) for i in range(parity, self.L - 1, 2)]
        if parity == 1:
            pairs.append((self.L - 1, 0))
        for where in pairs:
            U = self._get_gates([where], dt_frac * self._dt)[0]
            info = {"error": None}
            self._pt.gate_split_(U, where, info=info, **self.split_opts)
            if info.get("error") is not None:
                self._err += float(info["error"])
        if self.imag:
            self._pt.normalize()

    def _step_order2(self, tau=1.0, **sweep_opts):
        """Second-order Suzuki-Trotter step."""
        self.sweep("right", tau / 2, **sweep_opts)
        self.sweep("left", tau, **sweep_opts)
        self.sweep("right", tau / 2, **sweep_opts)

    def _step_order4(self, **sweep_opts):
        """Fourth-order Suzuki-Trotter step."""
        tau1 = tau2 = 1 / (4 - 4 ** (1 / 3))
        tau3 = 1 - 2 * tau1 - 2 * tau2
        for tau in (tau1, tau2, tau3, tau2, tau1):
            self._step_order2(tau, **sweep_opts)

    def step(self, order=2, dt=None, progbar=None, **sweep_opts):
        """Advance one time step: the gates of the engine's ``dt``
        (``sweep_opts`` go to :meth:`sweep`), while the clock, the Trotter
        error estimate and :attr:`taus` advance by ``dt``, the engine's
        unless given, as quimb_tpu's bookkeeping does. A ``progbar`` (a
        ``continuous_progbar``) is moved to the new time."""
        {2: self._step_order2, 4: self._step_order4}[order](**sweep_opts)
        dt = self._dt if dt is None else dt
        self.t += dt
        self._err += self._ham_norm * abs(dt) ** (order + 1)
        self.taus.append(dt)
        if progbar is not None:
            progbar.cupdate(self.t)

    def update_to(self, T, dt=None, tol=None, order=4, progbar=None):
        """Evolve to time ``T``; a last step that would overshoot is
        scaled down to end on ``T``. With ``progbar`` (the engine's
        ``progbar`` unless given) a progress bar follows the time."""
        if dt is None:
            if tol is None:
                tol = self.tol
            if tol is not None:
                dt = self.choose_time_step(tol, T - self.t, order)
            else:
                dt = self._dt
        self._dt = dt

        if progbar is None:
            progbar = self.progbar
        pbar = continuous_progbar(self.t, T) if progbar else None
        while self.t < T - self.TARGET_TOL:
            if self.t + self._dt > T:
                old_dt = self._dt
                self._dt = T - self.t
                self._U_cache = {}
                self.step(order=order, progbar=pbar)
                self._dt = old_dt
                self._U_cache = {}
            else:
                self.step(order=order, progbar=pbar)
        if pbar is not None:
            pbar.close()

    def at_times(self, ts, dt=None, tol=None, order=4, progbar=None):
        """Generator of the state at each time in ``ts``; no progress bar
        (``progbar`` is ignored, as quimb_tpu ignores it)."""
        for T in ts:
            self.update_to(T, dt=dt, tol=tol, order=order, progbar=False)
            yield self.pt


def OTOC_local(psi0, H, H_back, ts, i, A, j=None, B=None,
               initial_eigenstate="check", **tebd_opts):
    """The out-of-time-ordered correlator |<A_i(t) B_j A_i(t) B_j>| at
    each time of ``ts``, by forward and backward TEBD evolutions
    (reference ``OTOC_local`` tn1d/tebd.py:566)."""
    B = A if B is None else B
    j = i if j is None else j

    def evolve(psi, ham, t):
        tebd = TEBD(psi, ham, progbar=False, **tebd_opts)
        tebd.update_to(t)
        return tebd.pt

    for t in ts:
        # A_i(t)|psi>: forward, A_i, backward
        psi_x = evolve(evolve(psi0, H, t).gate(A, i, contract=True),
                       H_back, t)
        xBx = psi_x.gate(B, j, contract=True)
        # A_i(t) B_j |psi>
        yB = psi0.gate(B, j, contract=True)
        psi_z = evolve(evolve(yB, H, t).gate(A, i, contract=True),
                       H_back, t)
        yield abs(complex(expec_TN_1D(xBx.H, psi_z)))
