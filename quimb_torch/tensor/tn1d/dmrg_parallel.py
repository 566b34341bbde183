"""Segment-parallel DMRG sweeps (real-space parallel DMRG, batched).

Port of ``quimb_tpu/tensor/tn1d/dmrg_parallel.py``. The chain is cut
into S segments that are swept at the same time: every local solve,
split and environment absorption acts on all segments at once, as
batched tensors with a leading segment dimension. One outer sweep
(:func:`_parallel_outer_sweep`):

1. a reverse pass LQ-canonizes the padded stack (right-canonical
   B-form) while building every right environment
   (:func:`_canonize_right_and_renvs`);
2. a forward pass over the B-stack QR-canonizes it to A-form while
   building every left environment, and keeps the gauge ``R[j]``
   carried into each site (:func:`_canonize_left_and_lenvs`). Together
   they give every segment exact boundary environments in one mixed-
   canonical gauge of one state, with no inverse anywhere;
3. ``2 * inner_passes + 1`` half-sweeps inside all segments at once
   (right, then ``inner_passes`` times left and right), boundary
   environments frozen (:func:`_segment_inner`);
4. write-back: interior segments QR their last tensor and drop the
   triangular gauge, which the next segment's first tensor already
   holds; the final segment keeps it. Segment offsets alternate by half
   a segment every outer sweep, so that seams move.

quimb_tpu compiles an outer sweep into one XLA program of ``lax.scan``
loops; here the loops are Python loops over batched tensors. The
effective-Hamiltonian matvec is the sandwich kernel of
:mod:`quimb_torch.ops.cuda_kernels`: one prepared operand set per
segment and local solve, and per Lanczos step one launch per segment
(:func:`_matvec_via_sandwich`). quimb_tpu's switch between its einsum
pair and its Pallas kernel (``QUIMB_TPU_PAR_PALLAS``) has no
counterpart: on CUDA tensors the kernel runs, on CPU tensors its plain
version.

S >= 4 segments of a 128-site chain at chi=256 diverge, S = 2 is stable:
that is the block-Jacobi behaviour of the algorithm, which the port
keeps (``docs/performance.md``).
"""

import torch

from ...ops import decomp
from ...ops.cuda_kernels import resolve_sandwich
from .dmrg import _env_step_left, _env_step_right
from .dmrg_jacobi import (
    _batched_tridiag_eigvec,
    mpo_to_padded_stack,
    mps_to_stack,
    stack_to_mps,
)


# ---------------------------------------------------------------------------
# outer-phase passes: canonize + environment stacks
# ---------------------------------------------------------------------------


def bond_rank_masks(L, chi, d=2, dtype=torch.float32, device=None):
    """(L+1, chi) 0/1 masks of the true (untruncated) bond ranks of an
    open chain: ``masks[j]`` masks the bond left of site ``j``
    (``min(d**j, d**(L-j), chi)`` live columns). Padded-stack QR / LQ of
    rank-deficient edge matrices otherwise fills the dead directions
    with arbitrary orthonormal vectors, which the environments would
    then couple to."""
    m = torch.zeros((L + 1, chi), dtype=dtype, device=device)
    for j in range(L + 1):
        m[j, :min(d ** min(j, 63), d ** min(L - j, 63), chi)] = 1.0
    return m


def _boundary_env(chi, w, like):
    """The one-hot (chi, w, chi) environment of a chain end."""
    env = like.new_zeros((chi, w, chi))
    env[0, 0, 0] = 1.0
    return env


def _canonize_right_and_renvs(Ms, Ws, masks):
    """Reverse pass: right-canonize (LQ) every site while absorbing it
    into the right environment. Returns (Bstack, renvs), ``renvs[j]``
    the environment of sites >= j; the leftover left gauge (the norm) is
    dropped. ``masks`` (:func:`bond_rank_masks`) zero the dead left-bond
    directions of each B exactly."""
    L, chi, d, _ = Ms.shape
    renv = _boundary_env(chi, Ws.shape[1], Ms)
    R = torch.eye(chi, dtype=Ms.dtype, device=Ms.device)
    Bs, renvs = [None] * L, [None] * L
    for j in range(L - 1, -1, -1):
        # absorb the pending right gauge, then Mj = Lf @ Q
        Mj = torch.einsum("kdc,cr->kdr", Ms[j], R)
        Lf, _, Q = decomp.lq_stabilized(torch.reshape(Mj, (chi, d * chi)))
        mk = masks[j]
        R = Lf * mk[None, :]
        Bs[j] = torch.reshape(Q * mk[:, None], (chi, d, chi))
        renv = _env_step_left(renv, torch.conj(Bs[j]), Ws[j], Bs[j])
        renvs[j] = renv
    return torch.stack(Bs), torch.stack(renvs)


def _canonize_left_and_lenvs(Bstack, Ws, masks):
    """Forward pass over the right-canonical stack: QR-canonize to
    A-form while building every left environment, and keep the gauge
    carried into every site.

    Returns ``(Astack, lenvs, Rpre)``: ``lenvs[j]`` the environment of
    sites <= j from the orthonormal A-tensors; ``Rpre[j]`` the (chi, chi)
    gauge carried into site ``j``, the center matrix of the mixed-
    canonical form ``A[0..j-1] @ Rpre[j] @ B[j..]``. Dead right-bond
    directions of each A (and the matching gauge rows) are zeroed by
    ``masks``."""
    L, chi, d, _ = Bstack.shape
    lenv = _boundary_env(chi, Ws.shape[1], Bstack)
    # the gauge entering site 0 is the boundary projector, not the
    # identity: only left-bond direction 0 is physical
    R = Bstack.new_zeros((chi, chi))
    R[0, 0] = 1.0
    tiny = torch.finfo(Bstack.real.dtype).tiny
    As, lenvs, Rpre = [None] * L, [None] * L, [None] * L
    for j in range(L):
        Rpre[j] = R
        Mj = torch.einsum("ak,kdr->adr", R, Bstack[j])
        Q, _, Rn = decomp.qr_stabilized(torch.reshape(Mj, (chi * d, chi)))
        mk = masks[j + 1]
        Rn = Rn * mk[:, None]
        # keep the carried gauge normalized: its norm is the state norm
        # (1 after the reverse pass), but float32 drift compounds over
        # a long chain
        R = Rn / torch.clamp(torch.linalg.norm(Rn), min=tiny)
        As[j] = torch.reshape(Q * mk[None, :], (chi, d, chi))
        lenv = _env_step_right(lenv, torch.conj(As[j]), Ws[j], As[j])
        lenvs[j] = lenv
    return torch.stack(As), torch.stack(lenvs), torch.stack(Rpre)


# ---------------------------------------------------------------------------
# batched (over segments) inner sweeps with frozen boundary environments
# ---------------------------------------------------------------------------


def _sandwich_stacks(LW1, W2R):
    """Lay the fused environments out for the sandwich matvec
    (:mod:`quimb_torch.ops.cuda_kernels`): ``A (n, w, a*u, k*p)`` and
    ``B (n, w, q*r, v*b)``, contiguous, so that the effective-Hamiltonian
    matvec of segment ``i`` is ``sum_x A[i, x] @ th[i] @ B[i, x]`` with
    ``th (n, k*p, q*r)``."""
    n_, a, x, u, p, k = LW1.shape
    A = LW1.permute(0, 2, 1, 3, 5, 4).reshape(n_, x, a * u, k * p)
    _, _, v, q, b, r = W2R.shape
    B = W2R.permute(0, 1, 3, 5, 2, 4).reshape(n_, x, q * r, v * b)
    return A.contiguous(), B.contiguous()


def _matvec_via_sandwich(heffs, thm):
    """The segments' matvecs: ``heffs[i]`` is segment ``i``'s prepared
    sandwich, applied to ``thm[i]`` (k*p, q*r); the S launches run one
    after another on the current stream. Returns (n, a*u, v*b)."""
    return torch.stack([heff(thm[i]) for i, heff in enumerate(heffs)])


def _batched_solve_2site(Lb, W1, W2, Rb, th0, ncv, damp=1.0, sandwich=None):
    """Batched Lanczos lowest eigenpair of the 2-site effective
    Hamiltonians of S segments; th0 (S, chi, d, d, chi). Returns the raw
    Ritz values (S,) and the normalized Ritz vectors shaped like th0.

    ``sandwich`` is the prepare step of the sandwich matvec
    (:func:`quimb_torch.ops.cuda_kernels.resolve_sandwich`), by default
    resolved from ``th0``: each segment's stacks are prepared once per
    call. ``damp`` < 1 blends the Ritz vector with the warm start (a
    trust region for the block-Jacobi outer iteration)."""
    S_, chi, d, _, _ = th0.shape
    if sandwich is None:
        sandwich = resolve_sandwich(th0.device, th0.dtype)
    rdt = th0.real.dtype
    LW1 = torch.einsum("nawk,nwxup->naxupk", Lb, W1)
    W2R = torch.einsum("nxyvq,nbyr->nxvqbr", W2, Rb)
    A, B = _sandwich_stacks(LW1, W2R)
    heffs = [sandwich(A[i], B[i]) for i in range(S_)]
    n = chi * d * d * chi
    v = torch.reshape(th0, (S_, n))
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                        min=1e-30)
    V = th0.new_zeros((S_, ncv, n))
    V[:, 0] = v
    alpha = th0.new_zeros((S_, ncv), dtype=rdt)
    beta = th0.new_zeros((S_, ncv), dtype=rdt)
    for j in range(ncv):
        vj = V[:, j]
        hv = _matvec_via_sandwich(
            heffs, torch.reshape(vj, (S_, chi * d, d * chi)))
        hv = torch.reshape(hv, (S_, n))
        alpha[:, j] = torch.sum(torch.conj(vj) * hv, dim=-1).real
        for _ in range(2):
            proj = torch.einsum("nkx,nx->nk", torch.conj(V), hv)
            hv = hv - torch.einsum("nkx,nk->nx", V, proj)
        b = torch.linalg.norm(hv, dim=-1)
        beta[:, j] = b
        if j + 1 < ncv:
            V[:, j + 1] = torch.where((b > 1e-30)[:, None],
                                      hv / b[:, None], hv)
    ens, coeff = _batched_tridiag_eigvec(alpha, beta)
    th = torch.einsum("nk,nkx->nx", coeff.to(V.dtype), V)
    th = th / torch.clamp(torch.linalg.norm(th, dim=-1, keepdim=True),
                          min=1e-30)
    if damp != 1.0:
        # phase-align with the warm start before blending (the Ritz
        # vector's global sign is arbitrary)
        ov = torch.sum(torch.conj(V[:, 0]) * th, dim=-1, keepdim=True)
        th = torch.where(ov.real < 0, -th, th)
        th = V[:, 0] + damp * (th - V[:, 0])
        th = th / torch.clamp(torch.linalg.norm(th, dim=-1, keepdim=True),
                              min=1e-30)
    return ens, torch.reshape(th, th0.shape)


def _batched_split_2site(th, max_bond, absorb, oversample=0, power_iters=2,
                         Om=None):
    """Batched rank-``max_bond`` orthogonal split of th (S, chi, d, d, chi)
    -> (A1 (S, chi, d, k), A2 (S, k, d, chi)): the subspace split
    :func:`decomp.split_truncated_subspace` of every segment at once, from
    one start. The discarded side's factor carries the rest
    (absorb "right": A1 isometric). ``oversample=0`` skips the
    Rayleigh-Ritz rotation: the bond basis is pure gauge (the serial
    engine's "svd:sub0").

    ``Om`` (chi*d, max_bond + oversample) is the start of the iteration,
    shared by all segments; by default standard normal draws from a
    generator of ``th``'s device seeded 23, the same at every call."""
    S_, chi, d, _, _ = th.shape
    mat = torch.reshape(th, (S_, chi * d, d * chi))
    if Om is None:
        Om = decomp._random_start(
            (chi * d, min(max_bond + oversample, chi * d)), th.real.dtype,
            th.device, seed=23)
    U, _, VH, _ = decomp.split_truncated_subspace(
        mat, max_bond, absorb=absorb, iters=power_iters,
        oversample=oversample, omega=Om)
    return (torch.reshape(U, (S_, chi, d, max_bond)),
            torch.reshape(VH, (S_, max_bond, d, chi)))


def _segment_inner(seg_M0, seg_Ms, seg_W, lenv_b, renv_b, seg_bm, ncv,
                   max_bond, inner_passes, oversample=0, damp=1.0,
                   sandwich=None):
    """Batched fixed-boundary DMRG on S segments of m sites.

    seg_M0 (S, chi, d, chi): the first site tensor, which carries the
    center gauge; seg_Ms (S, m-1, chi, d, chi): the other site tensors,
    right-canonical; seg_W (S, m, w, w, d, d); lenv_b, renv_b
    (S, chi, w, chi): the frozen boundary environments; seg_bm
    (m-1, S, chi): true-rank masks of the segments' inner bonds, bond j
    between sites j and j+1 (splits at unsaturated edge bonds would
    otherwise fill dead directions).

    Runs a right half-sweep, then ``inner_passes`` times a left and a
    right one, ending left-canonical with the center gauge on the last
    site tensor. Returns (Arest (S, m-1, ...), Mlast, the (S,) energies
    of each bond of the final right half-sweep)."""
    m = seg_W.shape[1]
    kw = dict(ncv=ncv, damp=damp, sandwich=sandwich)

    def right_sweep(M0, Mrest):
        # the right environments inside the segments, from the current
        # (right-canonical) tensors: renvs[j] is right of site j + 1
        renvs = [None] * (m - 1)
        renv = renv_b
        for j in range(m - 2, -1, -1):
            renvs[j] = renv
            renv = _env_step_left(renv, torch.conj(Mrest[j]),
                                  seg_W[:, j + 1], Mrest[j])
        lenv, Mcur = lenv_b, M0
        A1s, ens = [], []
        for j in range(m - 1):
            W1, W2, bm = seg_W[:, j], seg_W[:, j + 1], seg_bm[j]
            th0 = torch.einsum("nkpc,ncqr->nkpqr", Mcur, Mrest[j])
            en, th = _batched_solve_2site(lenv, W1, W2, renvs[j], th0, **kw)
            A1, A2 = _batched_split_2site(th, max_bond, "right",
                                          oversample=oversample)
            A1 = A1 * bm[:, None, None, :]
            Mcur = A2 * bm[:, :, None, None]
            lenv = _env_step_right(lenv, torch.conj(A1), W1, A1)
            A1s.append(A1)
            ens.append(en)
        return A1s, Mcur, ens

    def left_sweep(Arest, Mlast):
        # the left environments inside the segments, from the current
        # (left-canonical) tensors: lenvs[j] is left of site j
        lenvs = [None] * (m - 1)
        lenv = lenv_b
        for j in range(m - 1):
            lenvs[j] = lenv
            lenv = _env_step_right(lenv, torch.conj(Arest[j]),
                                   seg_W[:, j], Arest[j])
        renv, Mcur = renv_b, Mlast
        A2s = [None] * (m - 1)
        for j in range(m - 2, -1, -1):
            W1, W2, bm = seg_W[:, j], seg_W[:, j + 1], seg_bm[j]
            th0 = torch.einsum("nkpc,ncqr->nkpqr", Arest[j], Mcur)
            _, th = _batched_solve_2site(lenvs[j], W1, W2, renv, th0, **kw)
            A1, A2 = _batched_split_2site(th, max_bond, "left",
                                          oversample=oversample)
            Mcur = A1 * bm[:, None, None, :]
            A2 = A2 * bm[:, :, None, None]
            renv = _env_step_left(renv, torch.conj(A2), W2, A2)
            A2s[j] = A2
        return Mcur, A2s

    Arest, Mlast, ens = right_sweep(seg_M0, list(seg_Ms.unbind(1)))
    for _ in range(inner_passes):
        M0, Brest = left_sweep(Arest, Mlast)
        Arest, Mlast, ens = right_sweep(M0, Brest)
    return torch.stack(Arest, dim=1), Mlast, ens


def _parallel_outer_sweep(Ms, Ws, masks, starts, m, ncv, max_bond,
                          inner_passes, oversample=0, off=0, damp=1.0,
                          sandwich=None):
    """One full outer sweep: canonize / environment passes, exact-gauge
    segment extraction, batched inner passes, gauge-dropping write-back.
    ``starts`` are the segments' first sites. Returns (new stack, the
    (S,) energies of each bond of the final right half-sweep)."""
    L, chi, d, _ = Ms.shape
    w = Ws.shape[1]
    Bstack, renvs = _canonize_right_and_renvs(Ms, Ws, masks)
    Astack, lenvs, Rpre = _canonize_left_and_lenvs(Bstack, Ws, masks)

    a = torch.as_tensor(starts, device=Ms.device)
    idx = a[:, None] + torch.arange(m, device=Ms.device)[None, :]
    segB = Bstack[idx]                          # (S', m, chi, d, chi)
    segW = Ws[idx]
    # the segments' inner bond masks, bond-aligned: (m-1, S', chi)
    seg_bm = torch.swapaxes(masks[idx[:, 1:]], 0, 1)

    end = _boundary_env(chi, w, Ms)
    Lb = torch.stack([end if s == 0 else lenvs[s - 1] for s in starts])
    Rb = torch.stack([end if s + m == L else renvs[s + m] for s in starts])

    # the exact center gauge at each left seam: M0 = Rpre[a] @ B[a]
    M0 = torch.einsum("nab,nbdr->nadr", Rpre[a], segB[:, 0])

    Arest, Mlast, ens = _segment_inner(
        M0, segB[:, 1:], segW, Lb, Rb, seg_bm, ncv=ncv, max_bond=max_bond,
        inner_passes=inner_passes, oversample=oversample, damp=damp,
        sandwich=sandwich,
    )

    # write-back: interior segments QR their gauge-carrying last tensor
    # and drop the triangular factor (the next segment's M0 holds it);
    # the final segment keeps it. The QR must be the sign-stabilized one:
    # the dropped factor's column signs have to match Rpre's (positive
    # diagonal, from qr_stabilized in the forward pass), or a +-1
    # diagonal is left at every seam
    Qs, _, _ = decomp.qr_stabilized(torch.reshape(Mlast, (-1, chi * d, chi)))
    # seam bond masks (interior seams are saturated at chi in production
    # configurations; dead directions still get zeroed exactly)
    Qs = Qs * masks[a + m][:, None, :]
    Alast = torch.reshape(Qs, Mlast.shape)
    nrm = torch.linalg.norm(torch.reshape(Mlast, (Mlast.shape[0], -1)),
                            dim=-1)
    Mlast_n = Mlast / torch.clamp(nrm, min=torch.finfo(nrm.dtype).tiny)[
        :, None, None, None]
    last_site = torch.cat([Alast[:-1], Mlast_n[-1:]])
    new = Bstack.clone()
    new[idx] = torch.cat([Arest, last_site[:, None]], dim=1)
    if off:
        # offset sweeps: the first segment's left environment is in the
        # A-basis, so the untouched prefix is stored A-form
        new[:off] = Astack[:off]
    return new, ens


class ParallelDMRG:
    """Steady-state segment-parallel sweep driver.

    Parameters
    ----------
    psi : MatrixProductState
        The start state, e.g. a converged :class:`DMRG2` state.
    ham : MatrixProductOperator
        The MPO (open chain), e.g. from :func:`MPO_ham_heis`.
    max_bond : int
        The uniform bond dimension (the state is padded to it).
    n_segments : int
        How many segments to sweep at once; L must divide into
        ``2 * n_segments`` (offsets alternate by half a segment).
    ncv : int
        Lanczos basis size per local solve.
    inner_passes : int
        (left + right) half-sweep pairs per outer sweep on top of the
        leading right half-sweep.
    oversample : int
        Extra subspace columns and a Rayleigh-Ritz rotation in the
        truncated split (0: pure subspace iteration).
    damp : float
        Blend of each Ritz vector with its warm start (1: none).

    Every tensor lives on the device of ``ham``, in the promotion of the
    MPO's and the state's dtypes; the sandwich matvec's prepare step is
    resolved here, once.
    """

    def __init__(self, psi, ham, max_bond, n_segments=8, ncv=8,
                 inner_passes=1, oversample=0, damp=1.0):
        self.like = psi
        self.chi = int(max_bond)
        self.S = int(n_segments)
        self.ncv = int(ncv)
        self.inner_passes = int(inner_passes)
        self.oversample = int(oversample)
        self.damp = float(damp)
        self.Ws = mpo_to_padded_stack(ham)
        self.Ms = mps_to_stack(psi, self.chi)
        device = self.Ws.device
        if self.Ms.device != device:
            raise ValueError("the MPO and the state must lie on one device")
        dtype = torch.promote_types(self.Ws.dtype, self.Ms.dtype)
        self.Ms = self.Ms.to(dtype)
        self.L = int(self.Ms.shape[0])
        if self.L % (2 * self.S):
            raise ValueError(
                f"L={self.L} must divide into 2*{self.S} half-segments"
            )
        self.m = self.L // self.S
        self.Ws = self.Ws.to(dtype)
        d = int(self.Ms.shape[2])
        self.masks = bond_rank_masks(self.L, self.chi, d, dtype=dtype,
                                     device=device)
        self._sandwich = resolve_sandwich(device, dtype)
        self.energies = []
        self._phase = 0

    def sweep(self):
        """One outer sweep; returns the mean over segments of the last
        bond's energy in the final right half-sweep."""
        L, m = self.L, self.m
        off = (m // 2) * (self._phase % 2)
        self._phase += 1
        starts = tuple(range(off, L - m + 1, m))
        self.Ms, ens = _parallel_outer_sweep(
            self.Ms, self.Ws, self.masks, starts, m=m, ncv=self.ncv,
            max_bond=self.chi, inner_passes=self.inner_passes,
            oversample=self.oversample, off=off, damp=self.damp,
            sandwich=self._sandwich,
        )
        en = float(torch.mean(ens[-1]))
        self.energies.append(en)
        return en

    def get_state(self):
        """The state as a :class:`MatrixProductState` like the start
        state, each bond cut to its live columns (:func:`stack_to_mps`)."""
        return stack_to_mps(self.Ms, self.like)
