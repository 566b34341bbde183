"""DMRG1 and DMRG2: density-matrix renormalization group ground-state
search.

Port of the open-chain engine of ``quimb_tpu/tensor/tn1d/dmrg.py``. The
sweep runs on the uniform array representation — site tensors
``(l, p, r)``, MPO tensors ``(wl, wr, u, d)`` (chain ends padded with
size-1 bonds), environments ``(b, w, k)`` — and at every bond (two-site,
``bsz=2``) or site (one-site, ``bsz=1``) it does four things:

- a restarted-Lanczos solve of the effective Hamiltonian
  (:func:`_local_solve_2site`, :func:`_local_solve_1site`), whose matvec
  is the sandwich kernel of :mod:`quimb_torch.ops.cuda_kernels`;
- a rank-``max_bond`` split of the updated two-site tensor
  (:func:`_split_2site`, by the method of ``bond_compress_method``), or a
  QR / LQ move of the one-site tensor's gauge;
- an environment absorption (:func:`_env_step_right` / ``_left``);
- the sweep driver (:class:`DMRG`), which right-canonizes the chain
  before a fresh right sweep.

While a profiler session records, these steps run inside the ranges of
:mod:`quimb_torch.tracing`: ``bond`` (a whole local update), within it
``local_solve``, ``lanczos_restart``, ``split`` and ``env_step`` (also
the environments built at a sweep's start), and ``canonize``.

The engines take quimb_tpu's arguments: an MPO object and an MPS start
state, whose uniform arrays they sweep; ``.state`` gives a
:class:`~.core.MatrixProductState` back. :class:`DMRGX` (dense local
solves, largest overlap) and :class:`MovingEnvironment` (the object-level
environments of a block of sites) come with them.

quimb_tpu fuses the uniform bulk of a sweep into ``lax.scan`` programs
only to cut XLA dispatches; here the per-site loop is the one path. The
energy comes back to the host once per sweep.
"""

import itertools

import numpy as np
import torch

from ...linalg.lanczos import _lanczos_basis, _tridiag_eigh
from ...ops import decomp
from ...ops.backend import to_host
from ...ops.cuda_kernels import resolve_sandwich
from ...tracing import span, spanned
from ..core import TensorNetwork
from .builders import MPS_rand_state
from .core import (
    _arrays_to_mps,
    _mpo_uniform_arrays,
    _mps_uniform_arrays,
)


def get_default_opts(cyclic=False, device=torch.device("cpu")):
    """The options the engine reads for tensors on ``device``, with
    quimb_tpu's defaults: its accelerator's split on a GPU, its CPU split
    on the CPU. On an H100 the subspace split takes 2.1-2.3 ms at a
    chi=256 bulk bond, against 54-56 ms for ``gesvd``. ``cyclic`` is
    ignored, as quimb_tpu ignores it: a ring reads the same options."""
    return {
        "default_sweep_sequence": "R",
        # "svd", "svd:eig", "svd:sub" or "svd:sub0" (_split_2site); a
        # sweep with no cutoff runs "svd:sub" as "svd:sub0"
        "bond_compress_method": ("svd:sub" if torch.device(device).type
                                 == "cuda" else "svd"),
        "local_eig_ncv": 4,
        # a sweep's Lanczos basis has max(2 * local_eig_ncv,
        # local_eig_ncv_floor) vectors
        "local_eig_ncv_floor": 8,
        "local_eig_restarts": 1,
        # the ring engine (dmrg_cyclic.CyclicSweeper): the noise of a bond
        # growth, the segment's share of the ring, and the closures'
        # compression tolerances, rank cap (-1: 128) and gauge inverse;
        # quimb_tpu's compress_method, nullspace_fudge_factor and
        # orthog_tol entries are kept, and read by neither engine
        "bond_expand_rand_strength": 1e-6,
        "periodic_segment_size": 1 / 2,
        "periodic_compress_method": "isvd",
        "periodic_compress_norm_eps": 1e-6,
        "periodic_compress_tol": 1e-6,
        "periodic_compress_max_bond": -1,
        "periodic_nullspace_fudge_factor": 1e-12,
        "periodic_canonize_inv_tol": 1e-10,
        "periodic_orthog_tol": 1e-6,
    }


class DMRGError(Exception):
    pass


class _EndlessSeq:
    """A 'last value repeats forever' sequence (bond-dim and cutoff
    schedules)."""

    def __init__(self, values):
        self.values = list(values)
        self.i = 0

    def __next__(self):
        v = self.values[min(self.i, len(self.values) - 1)]
        self.i += 1
        return v

    def __iter__(self):
        return self


# ---------------------------------------------------------------------------
# per-bond kernels (uniform array layout)
# ---------------------------------------------------------------------------


def _env_step_right(L, Ab, W, Ak):
    """Absorb one site into a left environment:
    L (b,w,k), Ab=conj ket (b,p,b2) bra side, W (w,w2,u,d), Ak (k,d,k2)
    -> (b2,w2,k2). Leading batch dimensions, shared by all four, pass
    through (the segment-parallel engine absorbs all segments at once)."""
    T = torch.einsum("...bwk,...kdx->...bwdx", L, Ak)
    T = torch.einsum("...bwdx,...wyud->...byux", T, W)
    return torch.einsum("...byux,...bua->...ayx", T, Ab)


def _env_step_left(R, Ab, W, Ak):
    """Absorb one site into a right environment:
    R (b,w,k), Ab (b2,p,b), W (w2,w,u,d), Ak (k2,d,k) -> (b2,w2,k2);
    leading batch dimensions as in :func:`_env_step_right`."""
    T = torch.einsum("...bwk,...xdk->...bwxd", R, Ak)
    T = torch.einsum("...bwxd,...ywud->...byxu", T, W)
    return torch.einsum("...byxu,...aub->...ayx", T, Ab)


def _fuse_lw(L, W1):
    """Fuse the left environment (a,w,k) with the first MPO tensor
    (w,x,u,p) into LW1 (a,x,u,p,k)."""
    return torch.einsum("awk,wxup->axupk", L, W1)


def _fuse_wr(W2, R):
    """Fuse the second MPO tensor (x,y,v,q) with the right environment
    (b,y,r) into W2R (x,v,q,b,r)."""
    return torch.einsum("xyvq,byr->xvqbr", W2, R)


def _heff_matvec_2site(LW1, W2R, theta):
    """theta (k,d1,d2,r) -> (a,u1,u2,b) as the einsum chain over the
    fusions. The sandwich operands of :func:`_sandwich_operands` compute
    the same product; the tests hold them against this."""
    T = torch.einsum("kpqr,axupk->auxqr", theta, LW1)
    return torch.einsum("auxqr,xvqbr->auvb", T, W2R)


def _sandwich_operands(L, W1, W2, R):
    """The fusions laid out for ``out = sum_x A[x] @ theta @ B[x]``:
    A (w, M=(a,u), K1=(k,p)) and B (w, K2=(q,r), N=(v,b)), contiguous.
    With theta as (K1, K2), the output (M, N) reshapes to theta's own
    shape because a, u, v, b range like k, p, q, r. The environments may
    hold a block of their bra rows (a of L, b of R: a sharded sweep's
    rows of M and columns of N, each block contiguous)."""
    (a, _, k), (_, w, d, _), (b, _, r) = L.shape, W1.shape, R.shape
    # (a,x,u,p,k) -> (x,a,u,k,p)
    A = _fuse_lw(L, W1).permute(1, 0, 2, 4, 3)
    # (x,v,q,b,r) -> (x,q,r,v,b)
    B = _fuse_wr(W2, R).permute(0, 2, 4, 1, 3)
    return (A.reshape(w, a * d, k * d).contiguous(),
            B.reshape(w, d * r, d * b).contiguous())


def _heff_matvec_1site(LW, R, theta):
    """theta (k,p,r) -> (a,u,b) via LW (a,x,u,p,k) and R (b,x,r)."""
    T = torch.einsum("kpr,axupk->auxr", theta, LW)
    return torch.einsum("auxr,bxr->aub", T, R)


def _sandwich_operands_1site(L, W, R):
    """The one-site operands of ``out = sum_x A[x] @ theta @ B[x]``:
    A (w, M=(a,u), K1=(k,p)) as in :func:`_sandwich_operands` and
    B = R as (w, K2=r, N=b), contiguous. theta (k,p,r) is (K1, K2)."""
    (a, _, k), (_, w, d, _) = L.shape, W.shape
    A = torch.einsum("awk,wxup->xaukp", L, W)
    return (A.reshape(w, a * d, k * d).contiguous(),
            R.permute(1, 2, 0).contiguous())


def _overlap_norm_2site(L, R, v, vb=None):
    """Exact ⟨ψ|ψ⟩ of the full MPS with 2-site tensor ``v`` (k,p,q,r),
    read off the environments' MPO identity channels: for a Schur-form
    MPO the left environment's channel 0 is the norm environment, and
    the right environment's last channel likewise. For environments that
    hold a block of their bra rows, ``vb`` is the same block of ``v``
    (rows of k, columns of r) and the result that block's part."""
    nL = L[:, 0, :]
    nR = R[:, -1, :]
    t = torch.einsum("ak,kpqr->apqr", nL, v)
    t = torch.einsum("apqr,br->apqb", t, nR)
    return torch.einsum("apqb,apqb->", torch.conj(v if vb is None else vb),
                        t).real


def _overlap_norm_1site(L, R, v, vb=None):
    """1-site variant of :func:`_overlap_norm_2site`; v is (k,p,r)."""
    nL = L[:, 0, :]
    nR = R[:, -1, :]
    t = torch.einsum("ak,kpr->apr", nL, v)
    t = torch.einsum("apr,br->apb", t, nR)
    return torch.einsum("apb,apb->", torch.conj(v if vb is None else vb),
                        t).real


def _lanczos_ground(heff, theta0, K1, K2, ncv, restarts):
    """Restarted-Lanczos lowest Ritz pair of the prepared sandwich
    ``heff`` applied to ``theta0`` reshaped to (K1, K2). Returns (Ritz
    value, normalized Ritz vector shaped like ``theta0``).

    The basis has at most ``theta0.numel()`` vectors: past the dimension
    of the space, a new Lanczos vector is rounding noise and its Ritz
    values are spurious (a one-site solve at a chain end has dimension
    1 * d * d = 4 < ncv = 8; quimb_tpu runs it with ncv vectors)."""
    ncv = min(ncv, theta0.numel())

    def matvec(th):
        out = heff(torch.reshape(th, (K1, K2)))
        return torch.reshape(out, theta0.shape)

    v = theta0 / torch.linalg.norm(torch.reshape(theta0, (-1,)))
    lam = None
    for _ in range(restarts):
        with span("lanczos_restart"):
            V, alpha, beta = _lanczos_basis(matvec, v, ncv)
            w, S = _tridiag_eigh(alpha, beta)
            lam = w[0]
            coeff = S[:, 0].to(V.dtype)
            vflat = coeff @ V
            vflat = vflat / torch.linalg.norm(vflat)
            v = torch.reshape(vflat, theta0.shape)
    return lam, v


@spanned("local_solve")
def _local_solve_2site(L, W1, W2, R, theta0, ncv, restarts,
                       norm_energy=True, sandwich=None):
    """Restarted-Lanczos ground state of the 2-site effective
    Hamiltonian. Returns (energy, theta), both on the device.

    ``sandwich`` is the prepare step of the sandwich matvec
    (:func:`quimb_torch.ops.cuda_kernels.resolve_sandwich`), resolved once
    by the caller; by default it is resolved from ``theta0``. It lays out
    the stacks once per solve; every Lanczos matvec applies them. With
    ``norm_energy`` the energy is the variational Rayleigh quotient
    ⟨ψ|H|ψ⟩/⟨ψ|ψ⟩ of the full updated MPS, with ⟨ψ|ψ⟩ from
    :func:`_overlap_norm_2site`; without it, the raw Ritz value.
    """
    if sandwich is None:
        sandwich = resolve_sandwich(theta0.device, theta0.dtype)
    A, B = _sandwich_operands(L, W1, W2, R)
    lam, v = _lanczos_ground(sandwich(A, B), theta0, A.shape[2],
                             B.shape[1], ncv, restarts)
    if norm_energy:
        lam = lam / _overlap_norm_2site(L, R, v)
    return lam, v


@spanned("local_solve")
def _local_solve_1site(L, W, R, theta0, ncv, restarts, norm_energy=True,
                       sandwich=None):
    """Restarted-Lanczos ground state of the 1-site effective
    Hamiltonian, theta0 (k,p,r); as :func:`_local_solve_2site`, with the
    sandwich operands of :func:`_sandwich_operands_1site` (K2 = N = r)
    and ⟨ψ|ψ⟩ from :func:`_overlap_norm_1site`."""
    if sandwich is None:
        sandwich = resolve_sandwich(theta0.device, theta0.dtype)
    A, B = _sandwich_operands_1site(L, W, R)
    lam, v = _lanczos_ground(sandwich(A, B), theta0, A.shape[2],
                             B.shape[1], ncv, restarts)
    if norm_energy:
        lam = lam / _overlap_norm_1site(L, R, v)
    return lam, v


#: the masked split of each bond_compress_method but "svd:sub0"
_MASKED_SPLITS = {
    "svd": decomp.svd_truncated_masked,
    "svd:eig": decomp.svd_truncated_masked_eig,
    "svd:sub": decomp.svd_truncated_masked_subspace,
}


@spanned("split")
def _split_2site(theta, max_bond, cutoff, absorb, method="svd",
                 oversample=0):
    """Split the updated theta (k,d1,d2,r) into A1 (k,d1,c) and
    A2 (c,d2,r), with ``c = min(max_bond, k d1, d2 r)``.

    ``method`` "svd", "svd:eig" and "svd:sub" zero-mask the values below
    ``cutoff`` (:func:`decomp.svd_truncated_masked` and its ``eig`` and
    ``subspace`` variants). "svd:sub0" is the pure subspace split
    :func:`decomp.split_truncated_subspace`: it ignores ``cutoff``, and
    ``oversample`` (0: no Rayleigh-Ritz rotation) is its padding."""
    k, d1, d2, r = theta.shape
    mat = torch.reshape(theta, (k * d1, d2 * r))
    if method == "svd:sub0":
        U, _, VH, rank = decomp.split_truncated_subspace(
            mat, max_bond=max_bond, absorb=absorb, oversample=oversample,
        )
    elif method in _MASKED_SPLITS:
        U, _, VH, rank = _MASKED_SPLITS[method](
            mat, max_bond=max_bond, cutoff=cutoff, cutoff_mode=4,
            absorb=absorb,
        )
    else:
        raise ValueError(f"unknown bond_compress_method {method!r}")
    chi = U.shape[-1]
    return (torch.reshape(U, (k, d1, chi)),
            torch.reshape(VH, (chi, d2, r)), rank)


def _right_canonize_step(A_next, A):
    """Make A (l,p,r) right-isometric by LQ, absorbing L into A_next.
    The absorbed factor is renormalized each step so that long chains
    never overflow float32 (the overall scale is irrelevant to the
    eigenproblem)."""
    l, p, r = A.shape
    Lf, _, Q = decomp.lq_stabilized(torch.reshape(A, (l, p * r)))
    newA = torch.reshape(Q, (Q.shape[0], p, r))
    newAnext = torch.einsum("apk,kc->apc", A_next, Lf)
    nrm = torch.linalg.norm(torch.reshape(newAnext, (-1,)))
    newAnext = newAnext / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    return newAnext, newA


def _right_canonized(As):
    """A right-canonical copy of the list state ``As`` (B-form), by LQ
    from the right end, its first tensor normalized."""
    As = list(As)
    for i in range(len(As) - 1, 0, -1):
        As[i - 1], As[i] = _right_canonize_step(As[i - 1], As[i])
    As[0] = As[0] / torch.linalg.norm(torch.reshape(As[0], (-1,)))
    return As


class _LocalSweep:
    """The steps of a sweep that :meth:`DMRG.shard_onto` distributes, on
    one device: environments as plain tensors, every step on this
    process. :class:`.dmrg_mesh.MeshSweep` has the same methods over the
    ranks of a mesh."""

    @staticmethod
    def ones_env(A, side):
        """The (1, 1, 1) environment past a chain end (``side`` 0 left,
        1 right)."""
        return torch.ones((1, 1, 1), dtype=A.dtype, device=A.device)

    @staticmethod
    @spanned("env_step")
    def env_right(L, A, W):
        """The left environment of the next site, absorbing A under W."""
        return _env_step_right(L, torch.conj(A), W, A)

    @staticmethod
    @spanned("env_step")
    def env_left(R, A, W):
        """The right environment of the previous site."""
        return _env_step_left(R, torch.conj(A), W, A)

    @staticmethod
    def solve_2site(*args, **kwargs):
        return _local_solve_2site(*args, **kwargs)

    @staticmethod
    def solve_1site(*args, **kwargs):
        return _local_solve_1site(*args, **kwargs)

    @staticmethod
    def share(fn):
        """``fn()``: a tuple of tensors (a split, a gauge move) that every
        rank must hold alike."""
        return fn()


def _mpo_has_identity_channels(Ws, tol=1e-10):
    """True when every MPO tensor has Schur (triangular FSM) form —
    first column ``[I, 0, ..]``ᵀ and last row ``[.., 0, I]`` — so that
    left environments' channel 0 and right environments' channel -1
    are exactly the pure-identity (norm) environments.

    The first-column condition is only needed on sites feeding a left
    environment (all but the last); the last-row condition on sites
    feeding a right environment (all but the first).
    """
    n = len(Ws)
    for i, W in enumerate(Ws):
        Wn = to_host(W)
        d = Wn.shape[2]
        eye = np.eye(d, dtype=Wn.dtype)
        if i < n - 1:
            col0 = Wn[:, 0]
            if not np.allclose(col0[0], eye, atol=tol):
                return False
            if col0.shape[0] > 1 and np.abs(col0[1:]).max() > tol:
                return False
        if i > 0:
            rowl = Wn[-1, :]
            if not np.allclose(rowl[-1], eye, atol=tol):
                return False
            if rowl.shape[0] > 1 and np.abs(rowl[:-1]).max() > tol:
                return False
    return True


# ---------------------------------------------------------------------------
# DMRG driver
# ---------------------------------------------------------------------------


class DMRG:
    """One- or two-site DMRG (reference ``DMRG`` dmrg.py:501).

    Parameters
    ----------
    ham : MatrixProductOperator
        The Hamiltonian, e.g. from :func:`MPO_ham_heis`. A cyclic one is
        swept by the ring engine (:class:`.dmrg_cyclic.CyclicSweeper`)
        with ``cyclic_mode="segmented"`` (with ``bsz=2`` and ``which=
        "SA"``), else brought to its exact open form (``ham.to_obc()``);
        ``"auto"`` picks the ring engine for 40 sites or more.
    bond_dims : int or sequence of int
        The bond dimension, or a schedule of them for successive sweeps.
    cutoffs : float or sequence of float
        The truncation cutoff (relative sum of squares), or a schedule.
    bsz : {2, 1}
        Sites per local update: two-site updates split the updated pair
        and can change the bond dimension; one-site updates move the
        gauge by QR / LQ and keep every bond as it is.
    which : str
        The eigenpair sought; only ``"SA"`` (the ground state) is swept.
    p0 : MatrixProductState, optional
        The start state, e.g. from :func:`MPS_rand_state`; random by
        default (``ham.rand_state``).

    The sweeps run on the uniform arrays of the MPO and the state (site
    tensors ``(l, p, r)``, MPO tensors ``(wl, wr, u, d)``), on the device
    of ``ham``; :attr:`state` gives the state back as a
    :class:`MatrixProductState`. The dtype is the promotion of the MPO's
    and the start state's. The sandwich matvec's prepare step is resolved
    here, once, from that device and dtype: a kernel's for float32 and
    float64 on CUDA, the plain product for complex dtypes and on the CPU.
    The ring engine's solves are plain products.
    """

    def __init__(self, ham, bond_dims, cutoffs=1e-9, bsz=2, which="SA",
                 p0=None, cyclic_mode="auto"):
        if bsz not in (1, 2):
            raise ValueError(f"bsz must be 1 or 2, got {bsz}")
        self.L = ham.L
        self.bsz = bsz
        self.which = which
        self.phys_dim = ham.phys_dim()
        self._set_bond_dim_seq(bond_dims)
        self._set_cutoff_seq(cutoffs)
        self.energies = []
        self.local_energies = []
        self._cyc = None
        if cyclic_mode == "auto":
            cyclic_mode = "segmented" if ham.L >= 40 else "obc"
        if getattr(ham, "cyclic", False):
            if cyclic_mode == "segmented" and bsz == 2 and which == "SA":
                self._init_ring(ham, p0)
                return
            ham = ham.to_obc()
        self.ham = ham
        self._W = _mpo_uniform_arrays(ham)
        device = self._W[0].device
        self.opts = get_default_opts(device=device)
        if p0 is None:
            p0 = MPS_rand_state(self.L, self._bond_dim0, self.phys_dim,
                                dtype=ham.dtype, device=device,
                                site_ind_id=ham.upper_ind_id,
                                site_tag_id=ham.site_tag_id)
        self._like = p0
        A = _mps_uniform_arrays(p0)
        if any(t.device != device for t in (*self._W, *A)):
            raise ValueError("the MPO and the start state must lie on "
                             "one device")
        dtype = self._W[0].dtype
        for t in (*self._W, *A):
            dtype = torch.promote_types(dtype, t.dtype)
        self._W = [W.to(dtype) for W in self._W]
        self._A = [a.to(dtype) for a in A]
        self._sandwich = resolve_sandwich(device, dtype)
        self._ops = _LocalSweep
        # with a Schur-form MPO the environments' identity channels give
        # ⟨ψ|ψ⟩ for free and the sweep energies are exact variational
        # Rayleigh quotients; without it, raw Ritz values
        self._norm_energy = _mpo_has_identity_channels(self._W)

    def _init_ring(self, ham, p0):
        """Set up the segmented ring engine on the cyclic MPO ``ham`` and
        the cyclic start state ``p0`` (random by default)."""
        # dmrg_cyclic builds on this module's steps
        from .dmrg_cyclic import (CyclicSweeper, cyclic_mpo_arrays,
                                  cyclic_mps_arrays)

        self.ham = ham
        Ws = cyclic_mpo_arrays(ham)
        device = Ws[0].device
        self.opts = get_default_opts(device=device)
        if p0 is None:
            p0 = MPS_rand_state(self.L, self._bond_dim0, self.phys_dim,
                                cyclic=True, dtype=ham.dtype, device=device,
                                site_ind_id=ham.upper_ind_id,
                                site_tag_id=ham.site_tag_id)
        self._like = p0
        As = cyclic_mps_arrays(p0)
        if any(t.device != device for t in As):
            raise ValueError("the MPO and the start state must lie on "
                             "one device")
        dtype = Ws[0].dtype
        for t in (*Ws, *As):
            dtype = torch.promote_types(dtype, t.dtype)
        self._cyc = CyclicSweeper([W.to(dtype) for W in Ws],
                                  [a.to(dtype) for a in As], self.opts)

    def _set_bond_dim_seq(self, bond_dims):
        if isinstance(bond_dims, int):
            bond_dims = [bond_dims]
        self._bond_dims = _EndlessSeq(bond_dims)
        self._bond_dim0 = self._bond_dims.values[0]

    def _set_cutoff_seq(self, cutoffs):
        if isinstance(cutoffs, float):
            cutoffs = [cutoffs]
        self._cutoffs = _EndlessSeq(cutoffs)

    @property
    def state(self):
        """The current state, a :class:`MatrixProductState` with the start
        state's index and tag ids, on the engine's device; cyclic when
        the ring engine sweeps it."""
        if self._cyc is not None:
            from .dmrg_cyclic import cyclic_arrays_to_mps

            return cyclic_arrays_to_mps(self._cyc._A, self._like)
        return _arrays_to_mps(self._A, like=self._like)

    @property
    def energy(self):
        return self.energies[-1] if self.energies else None

    # -- the mesh -----------------------------------------------------------

    def shard_onto(self, mesh, axes=None):
        """Distribute the sweeps over the ranks of ``mesh``, a
        ``DeviceMesh`` of :mod:`quimb_torch.parallel` (``get_mesh_2d()``):
        left environments are sharded on their bra chi over ``axes[0]``,
        right environments over ``axes[1]`` (the mesh's first two axes by
        default; one axis shards the left ones only), where the size
        divides the axis, and replicated elsewhere. Each rank applies the
        sandwich matvec to its rows of M and columns of N, and one
        all-gather assembles the output; the Lanczos solve runs replicated,
        the first rank's split (or QR / LQ move) is broadcast, and each
        environment step sums the rank's rows and all-reduces them over
        its axis (:class:`.dmrg_mesh.MeshSweep`). Site
        tensors stay whole on every rank, so :attr:`state` is this rank's.
        Every rank calls each method with the same arguments. On a one-rank
        mesh every block is whole and the sweeps do the unsharded
        arithmetic."""
        from .dmrg_mesh import MeshSweep

        if self._cyc is not None:
            raise NotImplementedError("the ring engine's sweeps are not "
                                      "sharded: shard_onto takes an open "
                                      "chain")
        if axes is None:
            axes = tuple(mesh.mesh_dim_names[:2])
        if len(axes) == 1:
            axes = (axes[0], None)
        self._ops = MeshSweep(mesh, axes, self._A[0])
        self._A = list(self._ops.share(lambda: [a.clone() for a in self._A]))
        return self

    @spanned("canonize")
    def _right_canonize_all(self):
        """Bring all sites into right-canonical form (B-form)."""
        self._A = list(self._ops.share(lambda: _right_canonized(self._A)))

    def _ones_env(self, side=0):
        return self._ops.ones_env(self._A[0], side)

    def _build_right_envs(self):
        """Right environments renv[j] = contraction of sites >= j, for
        the j >= bsz a right sweep reads."""
        L = self.L
        renv = [None] * (L + 1)
        renv[L] = self._ones_env(1)
        for j in range(L - 1, self.bsz - 1, -1):
            renv[j] = self._ops.env_left(renv[j + 1], self._A[j], self._W[j])
        return renv

    def _build_left_envs(self):
        """Left environments lenv[j] = contraction of sites < j, for the
        j <= L - bsz a left sweep reads."""
        lenv = [None] * (self.L + 1)
        lenv[0] = self._ones_env(0)
        for j in range(self.L - self.bsz):
            lenv[j + 1] = self._ops.env_right(lenv[j], self._A[j],
                                              self._W[j])
        return lenv

    def _solve_opts(self):
        ncv = max(self.opts["local_eig_ncv"] * 2,
                  self.opts["local_eig_ncv_floor"])
        return dict(ncv=ncv, restarts=self.opts["local_eig_restarts"],
                    norm_energy=self._norm_energy, sandwich=self._sandwich)

    def _split_method(self, cutoff):
        """The sweep's split method: with no cutoff to mask, "svd:sub"
        runs as the cheaper pure subspace split "svd:sub0"."""
        method = self.opts["bond_compress_method"]
        if method == "svd:sub" and not (cutoff and float(cutoff) > 0.0):
            return "svd:sub0"
        return method

    @spanned("bond")
    def _update_right(self, i, lenv, renv, max_bond, cutoff, method,
                      solve_opts):
        """The local update at site i of a right sweep; returns its
        energy and the left environment of site i + 1."""
        ops = self._ops
        if self.bsz == 2:
            theta0 = torch.einsum("kpc,cqr->kpqr", self._A[i],
                                  self._A[i + 1])
            en, theta = ops.solve_2site(
                lenv, self._W[i], self._W[i + 1], renv[i + 2], theta0,
                **solve_opts,
            )
            self._A[i], self._A[i + 1] = ops.share(lambda: _split_2site(
                theta, max_bond=max_bond, cutoff=cutoff, absorb="right",
                method=method)[:2])
        else:
            en, theta = ops.solve_1site(
                lenv, self._W[i], renv[i + 1], self._A[i], **solve_opts)
            if i < self.L - 1:
                # move the gauge right: theta = Q R, R into site i + 1
                l, p, r = theta.shape
                Q, Rf = ops.share(lambda: decomp.qr_stabilized(
                    torch.reshape(theta, (l * p, r)))[::2])
                self._A[i] = torch.reshape(Q, (l, p, Q.shape[-1]))
                self._A[i + 1] = torch.einsum("ck,kpr->cpr", Rf,
                                              self._A[i + 1])
            else:
                self._A[i] = theta
        return en, ops.env_right(lenv, self._A[i], self._W[i])

    @spanned("bond")
    def _update_left(self, i, lenvs, renv, max_bond, cutoff, method,
                     solve_opts):
        """The local update at site i of a left sweep; returns its energy
        and the right environment of site i + bsz - 1."""
        ops = self._ops
        if self.bsz == 2:
            theta0 = torch.einsum("kpc,cqr->kpqr", self._A[i],
                                  self._A[i + 1])
            en, theta = ops.solve_2site(
                lenvs[i], self._W[i], self._W[i + 1], renv, theta0,
                **solve_opts,
            )
            self._A[i], self._A[i + 1] = ops.share(lambda: _split_2site(
                theta, max_bond=max_bond, cutoff=cutoff, absorb="left",
                method=method)[:2])
        else:
            en, theta = ops.solve_1site(
                lenvs[i], self._W[i], renv, self._A[i], **solve_opts)
            if i > 0:
                # move the gauge left: theta = L Q, L into site i - 1
                l, p, r = theta.shape
                Lf, Q = ops.share(lambda: decomp.lq_stabilized(
                    torch.reshape(theta, (l, p * r)))[::2])
                self._A[i] = torch.reshape(Q, (Q.shape[0], p, r))
                self._A[i - 1] = torch.einsum("kpr,rc->kpc",
                                              self._A[i - 1], Lf)
            else:
                self._A[i] = theta
        j = i + self.bsz - 1
        return en, ops.env_left(renv, self._A[j], self._W[j])

    def _sweep_right(self, max_bond, cutoff):
        method = self._split_method(cutoff)
        solve_opts = self._solve_opts()
        renv = self._build_right_envs()
        lenv = self._ones_env(0)
        energies = []
        for i in range(self.L - self.bsz + 1):
            en, lenv = self._update_right(i, lenv, renv, max_bond, cutoff,
                                          method, solve_opts)
            energies.append(en)
        self.local_energies.append(energies)
        return float(energies[-1].real)

    def _sweep_left(self, max_bond, cutoff):
        method = self._split_method(cutoff)
        solve_opts = self._solve_opts()
        lenvs = self._build_left_envs()
        renv = self._ones_env(1)
        energies = []
        for i in range(self.L - self.bsz, -1, -1):
            en, renv = self._update_left(i, lenvs, renv, max_bond, cutoff,
                                         method, solve_opts)
            energies.append(en)
        self.local_energies.append(energies)
        return float(energies[-1].real)

    def sweep(self, direction, max_bond=None, cutoff=1e-9, canonize=True,
              verbosity=0):
        """One full sweep, ``"R"`` or ``"L"``; returns its last energy.
        A right sweep with ``canonize`` first right-canonizes the
        chain. On a ring the engine sweeps its segments, with at least two
        Lanczos restarts, and gauges each one itself. ``verbosity`` is
        ignored, as quimb_tpu's sweeps ignore it."""
        if self._cyc is not None:
            ncv = max(2 * self.opts["local_eig_ncv"],
                      self.opts["local_eig_ncv_floor"])
            return self._cyc.sweep(
                direction, max_bond=max_bond, cutoff=cutoff, ncv=ncv,
                restarts=max(self.opts["local_eig_restarts"], 2),
                method=self.opts["bond_compress_method"])
        if direction == "R":
            if canonize:
                self._right_canonize_all()
            return self._sweep_right(max_bond, cutoff)
        elif direction == "L":
            return self._sweep_left(max_bond, cutoff)
        raise ValueError(f"bad direction {direction}")

    def solve(self, tol=1e-4, bond_dims=None, cutoffs=None,
              sweep_sequence=None, max_sweeps=10, verbosity=0,
              suppress_warnings=True):
        """Sweep until two successive sweep energies differ by less than
        ``tol``. Returns whether that happened within ``max_sweeps``. With
        ``verbosity`` each sweep's energy is printed; ``suppress_warnings``
        is ignored, as quimb_tpu ignores it."""
        if bond_dims is not None:
            self._set_bond_dim_seq(bond_dims)
        if cutoffs is not None:
            self._set_cutoff_seq(cutoffs)
        if sweep_sequence is None:
            sweep_sequence = self.opts["default_sweep_sequence"]

        RLs = itertools.cycle(sweep_sequence)
        previous_LR = "0"
        for s in range(max_sweeps):
            LR = next(RLs)
            max_bond = next(self._bond_dims)
            cutoff = next(self._cutoffs)
            # no re-canonization where the sweep direction alternates
            canonize = LR + previous_LR not in {"RL", "LR"}
            en = self.sweep(LR, max_bond=max_bond, cutoff=cutoff,
                            canonize=canonize, verbosity=verbosity)
            self.energies.append(en)
            if verbosity:
                print(f"sweep {s + 1} ({LR}): max_bond={max_bond}, "
                      f"energy={en}")
            previous_LR = LR
            if len(self.energies) > 1:
                if abs(self.energies[-2] - self.energies[-1]) < tol:
                    return True
        return False


class DMRG1(DMRG):
    """One-site DMRG, with quimb_tpu's defaults (reference dmrg.py:1147)."""

    def __init__(self, ham, which="SA", bond_dims=None, cutoffs=1e-8,
                 p0=None, **kwargs):
        super().__init__(
            ham, bond_dims=bond_dims if bond_dims is not None else 8,
            cutoffs=cutoffs, bsz=1, which=which, p0=p0, **kwargs,
        )


class DMRG2(DMRG):
    """Two-site DMRG, with quimb_tpu's defaults (reference dmrg.py:1166)."""

    def __init__(self, ham, which="SA", bond_dims=None, cutoffs=1e-8,
                 p0=None, **kwargs):
        super().__init__(
            ham, bond_dims=bond_dims if bond_dims is not None else 8,
            cutoffs=cutoffs, bsz=2, which=which, p0=p0, **kwargs,
        )


class DMRGX(DMRG):
    """DMRG-X: the eigenstate of largest overlap with the current state,
    for interior (MBL) eigenstates (reference ``DMRGX`` dmrg.py:1190). The
    local problem is solved densely: ``eigh`` of the effective
    Hamiltonian built column by column, the eigenvector of largest overlap
    with the current tensor kept."""

    def __init__(self, ham, p0, bond_dims, cutoffs=1e-8, bsz=2):
        super().__init__(ham, bond_dims=bond_dims, cutoffs=cutoffs, bsz=bsz,
                         p0=p0)

    def shard_onto(self, mesh, axes=None):
        """Run on every rank of ``mesh`` replicated: DMRGX's dense local
        solves build the whole effective Hamiltonian, so each rank sweeps
        the whole chain with its site tensors whole, and every rank's
        energies are the unsharded ones (as quimb_tpu's sharded DMRGX
        returns its unsharded energies). Every rank calls each method
        with the same arguments."""
        return self

    def _local_solve_dense_overlap(self, lenv, Ws, renv, theta0):
        shape = theta0.shape
        if len(Ws) == 2:
            LW1, W2R = _fuse_lw(lenv, Ws[0]), _fuse_wr(Ws[1], renv)
            mv = lambda th: _heff_matvec_2site(LW1, W2R, th)  # noqa: E731
        else:
            LW = _fuse_lw(lenv, Ws[0])
            mv = lambda th: _heff_matvec_1site(LW, renv, th)  # noqa: E731
        n = theta0.numel()
        eye = torch.eye(n, dtype=theta0.dtype, device=theta0.device)
        H = torch.stack([mv(e.reshape(shape)).reshape(n) for e in eye],
                        dim=1)
        w, V = torch.linalg.eigh(H)
        overlaps = torch.abs(decomp.dag(V) @ theta0.reshape(n)) ** 2
        best = int(torch.argmax(overlaps))
        return w[best], V[:, best].reshape(shape)

    def _sweep_right(self, max_bond, cutoff):
        renv = self._build_right_envs()
        lenv = self._ones_env()
        energies = []
        for i in range(self.L - self.bsz + 1):
            if self.bsz == 2:
                theta0 = torch.einsum("kpc,cqr->kpqr", self._A[i],
                                      self._A[i + 1])
                en, theta = self._local_solve_dense_overlap(
                    lenv, (self._W[i], self._W[i + 1]), renv[i + 2], theta0)
                self._A[i], self._A[i + 1], _ = _split_2site(
                    theta, max_bond=max_bond, cutoff=cutoff, absorb="right")
            else:
                en, theta = self._local_solve_dense_overlap(
                    lenv, (self._W[i],), renv[i + 1], self._A[i])
                if i < self.L - 1:
                    l, p, r = theta.shape
                    Q, _, Rf = decomp.qr_stabilized(theta.reshape(l * p, r))
                    self._A[i] = Q.reshape(l, p, Q.shape[-1])
                    self._A[i + 1] = torch.einsum("ck,kpr->cpr", Rf,
                                                  self._A[i + 1])
                else:
                    self._A[i] = theta
            A = self._A[i]
            lenv = _env_step_right(lenv, torch.conj(A), self._W[i], A)
            energies.append(en)
        self.local_energies.append(energies)
        return float(energies[-1].real)

    def _sweep_left(self, max_bond, cutoff):
        # right-canonize, then sweep right again
        self._right_canonize_all()
        return self._sweep_right(max_bond, cutoff)


# ---------------------------------------------------------------------------
# MovingEnvironment
# ---------------------------------------------------------------------------


class MovingEnvironment:
    """The environments of a block of ``bsz`` sites of a 1D-structured
    network, moved one site at a time (reference ``MovingEnvironment``
    dmrg.py:105). Open chains: a ring Hamiltonian reaches DMRG in its
    open form (``MatrixProductOperator.to_obc``)."""

    def __init__(self, tn, begin, bsz, ssz=0.5, **kwargs):
        self.tn = tn
        self.begin = begin
        self.bsz = bsz
        self.L = tn._L
        self.init_environments()

    def site_tag(self, i):
        return self.tn.site_tag(i % self.L)

    def _absorb(self, j, env, output_inds=None):
        """The column ``j`` contracted with the environment network
        ``env`` (or alone), as a one-tensor network."""
        new = self.tn.select(self.site_tag(j), which="any").copy(
            virtual=False)
        if env is not None:
            new.add_tensor_network(env, virtual=True, check_collisions=False)
        envt = new.contract(..., preserve_tensor=True,
                            output_inds=output_inds)
        return TensorNetwork((envt,), virtual=True, check_collisions=False)

    def init_environments(self):
        L, bsz = self.L, self.bsz
        env = None
        if self.begin == "left":
            # right environments R[j]: the contraction of columns >= j
            self._renvs = {L: None}
            for j in range(L - 1, bsz - 1, -1):
                env = self._renvs[j] = self._absorb(
                    j, env, self._boundary_inds(j))
            self._lenvs = {0: None}
            self.pos = 0
        else:
            self._lenvs = {-1: None}
            for j in range(0, L - bsz):
                env = self._lenvs[j] = self._absorb(
                    j, env, self._boundary_inds(j, side="right"))
            self._renvs = {L: None}
            self.pos = L - bsz

    def _boundary_inds(self, j, side="left"):
        """The indices crossing the boundary left of column ``j``
        (``side="left"``) or right of it, then the block's other outer
        indices."""
        tn = self.tn
        inside = range(j, self.L) if side == "left" else range(0, j + 1)
        outside = range(0, j) if side == "left" else range(j + 1, self.L)
        block = tn.select_any(tuple(map(self.site_tag, inside)))
        if not outside:
            return block.outer_inds()
        rest_inds = set(tn.select_any(tuple(map(self.site_tag,
                                                outside))).ind_map)
        return (tuple(ix for ix in block.ind_map if ix in rest_inds)
                + tuple(ix for ix in block.outer_inds()
                        if ix not in rest_inds))

    def move_right(self):
        i = self.pos
        self._lenvs[i] = self._absorb(i, self._lenvs.get(i - 1))
        self.pos += 1

    def move_left(self):
        i = self.pos + self.bsz - 1
        self._renvs[i] = self._absorb(i, self._renvs.get(i + 1))
        self.pos -= 1

    def move_to(self, i):
        while self.pos < i:
            self.move_right()
        while self.pos > i:
            self.move_left()

    def init_segment(self, begin, start, stop):
        """Rebuild the environments to sweep from the ``begin`` side
        (reference ``init_segment`` dmrg.py:281; open chains rebuild them
        all)."""
        self.begin = begin
        self.init_environments()
        return self

    def init_non_segment(self, start, stop):
        """Nothing to prepare outside the segment on an open chain
        (reference ``init_non_segment`` dmrg.py:324)."""
        return self

    def __call__(self):
        """The current environment network: left environment, the block's
        sites (views of the network's tensors) and right environment."""
        i = self.pos
        block = self.tn.select_any(
            tuple(self.site_tag(j) for j in range(i, i + self.bsz)))
        out = TensorNetwork((), virtual=True)
        for part in (self._lenvs.get(i - 1), block,
                     self._renvs.get(i + self.bsz)):
            if part is not None:
                out.add_tensor_network(part, virtual=True,
                                       check_collisions=False)
        return out


# ---------------------------------------------------------------------------
# the rest of DMRG's methods (reference dmrg.py:647-991)
# ---------------------------------------------------------------------------


def _dmrg_sweep_right(self, canonize=True, verbosity=0, **update_opts):
    """One left-to-right sweep at the schedules' next values (reference
    ``sweep_right`` dmrg.py:983)."""
    return self.sweep("R", max_bond=next(self._bond_dims),
                      cutoff=next(self._cutoffs), canonize=canonize)


def _dmrg_sweep_left(self, canonize=True, verbosity=0, **update_opts):
    """One right-to-left sweep (reference ``sweep_left`` dmrg.py:991)."""
    return self.sweep("L", max_bond=next(self._bond_dims),
                      cutoff=next(self._cutoffs), canonize=canonize)


def _dmrg_form_local_ops(self, i):
    """The dense effective Hamiltonian of the ``bsz``-site block at ``i``
    (reference ``form_local_ops`` dmrg.py:681), a diagnostic built from
    the current arrays with the sweeps' environment steps."""
    lenv, renv = self._ones_env(), self._ones_env()
    for j in range(i):
        lenv = _env_step_right(lenv, torch.conj(self._A[j]), self._W[j],
                               self._A[j])
    for j in range(self.L - 1, i + self.bsz - 1, -1):
        renv = _env_step_left(renv, torch.conj(self._A[j]), self._W[j],
                              self._A[j])
    d, dl = self.phys_dim, self._A[i].shape[0]
    if self.bsz == 2:
        LW1, W2R = _fuse_lw(lenv, self._W[i]), _fuse_wr(self._W[i + 1], renv)
        shape = (dl, d, d, self._A[i + 1].shape[2])
        mv = lambda th: _heff_matvec_2site(LW1, W2R, th)  # noqa: E731
    else:
        LW = _fuse_lw(lenv, self._W[i])
        shape = (dl, d, self._A[i].shape[2])
        mv = lambda th: _heff_matvec_1site(LW, renv, th)  # noqa: E731
    dim = int(np.prod(shape))
    eye = torch.eye(dim, dtype=self._A[0].dtype, device=self._A[0].device)
    return torch.stack([mv(e.reshape(shape)).reshape(dim) for e in eye],
                       dim=1)


def _dmrg_print_energy_info(self, Heff=None, loc_gs=None):
    """Print the state's energy and, given a local operator and vector,
    the local one (reference ``print_energy_info`` dmrg.py:647)."""
    psi = self.state
    full_en = complex((psi.H @ self.ham.apply(psi)) / (psi.H @ psi)).real
    site_en = "N/A"
    if Heff is not None and loc_gs is not None:
        v = torch.reshape(torch.as_tensor(loc_gs, device=Heff.device), (-1,))
        site_en = complex(torch.vdot(v, Heff @ v)).real
    print(f"Sweep {len(self.energies) + 1} -- fullE={full_en} "
          f"siteE={site_en}")


def _dmrg_print_norm_info(self, i=None):
    """Print the state's norm and the sites' (or site ``i``'s) squared
    norms (reference ``print_norm_info`` dmrg.py:662)."""
    psi = self.state
    full_n = complex(psi.H @ psi).real
    if i is None:
        site_norm = [float(torch.vdot(a.reshape(-1), a.reshape(-1)).real)
                     for a in self._A]
    else:
        a = self._A[i].reshape(-1)
        site_norm = float(torch.vdot(a, a).real)
    print(f"Sweep {len(self.energies) + 1} -- fullN={full_n} "
          f"siteN={site_norm}")


def _dmrg_post_check(self, i, Neff, loc_gs, loc_en, loc_gs_old):
    """Open-chain sweeps keep exact orthogonality: nothing to correct
    (reference ``post_check`` dmrg.py:734)."""
    return loc_en, loc_gs


DMRG.sweep_right = _dmrg_sweep_right
DMRG.sweep_left = _dmrg_sweep_left
DMRG.form_local_ops = _dmrg_form_local_ops
DMRG.print_energy_info = _dmrg_print_energy_info
DMRG.print_norm_info = _dmrg_print_norm_info
DMRG.post_check = _dmrg_post_check
