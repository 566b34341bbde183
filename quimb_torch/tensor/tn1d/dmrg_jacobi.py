"""Batched Jacobi DMRG: all bonds of one parity solved at once.

Port of ``quimb_tpu/tensor/tn1d/dmrg_jacobi.py``. The conversions between
MPS / MPO objects and zero-padded uniform stacks, the batched two-site
matvec and the batched tridiagonal eigenvector are shared with
:mod:`quimb_torch.tensor.tn1d.dmrg_parallel`; the rest is the whitened
brickwork engine, :class:`JacobiDMRG`.

The state is a plain uniform stack ``Ms`` (L, chi, d, chi) in whatever
gauge it is in. Each half-sweep (:func:`_jacobi_halfsweep`) builds every
H environment and every norm environment ``N_L`` / ``N_R`` in four passes
over the stack, then whitens each bond's local problem by Cholesky
factors of its norm environments, ``H~ = C^-1 H_eff C^-H`` with
``N_eff = C C^H`` (:func:`_chol_and_inv`), so that the generalized
problem becomes a standard hermitian one in any gauge. All bonds of one
parity are then solved together: a batched Lanczos with full
reorthogonalisation and a fixed basis size, a rank-chi truncation in the
whitened metric by an oversampled randomized subspace and one small
batched ``eigh``, and the new site pair ``M_i = C_L^-H U sqrt(s)``,
``M_i+1 = sqrt(s) V C_R^-T``. Updates within a half-sweep use the
environments of the state it started from (Jacobi), which has the fixed
point of the sequential sweep; after every half-sweep
:func:`_renormalize_stack` balances the tensors' magnitudes.

quimb_tpu compiles a half-sweep into one XLA program of ``lax.scan`` and
``fori_loop``; here those are Python loops over batched tensors on the
stack's device. Its subspace start is ``jax.random.normal`` under
``PRNGKey(17 + parity)``, which torch cannot reproduce: the port draws
it from a ``torch.Generator`` on the stack's device with the same seed,
and :func:`_jacobi_halfsweep` (``omega=``) and :class:`JacobiDMRG`
(``omega=``, by parity) take a given start instead. A norm environment
that is not positive definite after the dead-direction fix and the
``8 eps tr`` shift raises, naming the parity and the bonds, where JAX's
Cholesky returns NaN.
"""

import torch

from ...ops import decomp
from ...ops.backend import to_device
from .core import _arrays_to_mps, _mpo_uniform_arrays, _mps_uniform_arrays
from .dmrg import _env_step_left, _env_step_right


def mps_to_stack(psi, chi):
    """Uniform (L, chi, d, chi) stack of the open MPS ``psi``'s site
    tensors, zero-padded on both bonds, on its device."""
    state = _mps_uniform_arrays(psi)
    L, d = len(state), state[0].shape[1]
    A0 = state[0]
    dtype = A0.dtype
    for A in state:
        dtype = torch.promote_types(dtype, A.dtype)
    Ms = torch.zeros((L, chi, d, chi), dtype=dtype, device=A0.device)
    for j, A in enumerate(state):
        kl, _, kr = A.shape
        if kl > chi or kr > chi:
            raise ValueError(
                f"bond dimension {max(kl, kr)} exceeds stack chi={chi}"
            )
        Ms[j, :kl, :, :kr] = A
    return Ms


def _stack_to_arrays(Ms, tol=0.0):
    """Site tensors ``(l, p, r)`` of the padded stack ``Ms``, with each
    inner bond cut to its count of live columns: those with an entry
    above ``tol`` on either side of the bond (quimb_tpu's rule, at least
    one). The chain ends get size-1 bonds."""
    L = Ms.shape[0]
    wr = Ms[:-1].abs().amax(dim=(1, 2))         # right bond of site j - 1
    wl = Ms[1:].abs().amax(dim=(2, 3))          # left bond of site j
    alive = ((wr > tol) | (wl > tol)).sum(dim=-1).tolist()
    ranks = [1] + [max(int(r), 1) for r in alive] + [1]
    return [Ms[j, :ranks[j], :, :ranks[j + 1]].clone() for j in range(L)]


def stack_to_mps(Ms, like, tol=0.0):
    """The padded stack ``Ms`` as an MPS with the index and tag ids of
    ``like``, each bond cut to its live columns (:func:`_stack_to_arrays`)."""
    return _arrays_to_mps(_stack_to_arrays(Ms, tol), like=like)


def mpo_to_padded_stack(ham, w=None):
    """Uniform (L, w, w, d, d) stack of the open MPO ``ham``'s tensors;
    the chain ends' size-1 bonds sit at channel 0, to pair with one-hot
    channel-0 boundary environments."""
    ham_arrays = _mpo_uniform_arrays(ham)
    if w is None:
        w = max(max(W.shape[0], W.shape[1]) for W in ham_arrays)
    W0 = ham_arrays[0]
    d = W0.shape[-1]
    Ws = torch.zeros((len(ham_arrays), w, w, d, d), dtype=W0.dtype,
                     device=W0.device)
    for j, W in enumerate(ham_arrays):
        Ws[j, :W.shape[0], :W.shape[1]] = W
    return Ws


def _batched_matvec(LW1, W2R, th):
    """Batched 2-site Heff matvec: th (nb, k, d, d, r) via LW1
    (nb, a, x, u, p, k) and W2R (nb, x, v, q, b, r)."""
    t = torch.einsum("nkpqr,naxupk->nauxqr", th, LW1)
    return torch.einsum("nauxqr,nxvqbr->nauvb", t, W2R)


def _batched_tridiag_eigvec(alpha, beta):
    """Smallest eigenpair (value, coefficients) of batched (ncv)
    symmetric tridiagonals (alpha, beta)."""
    ncv = alpha.shape[-1]
    eye = torch.eye(ncv, dtype=alpha.dtype, device=alpha.device)
    T = alpha[..., :, None] * eye
    off = torch.diag_embed(beta[..., :ncv - 1], offset=1)
    T = T + off + off.transpose(-2, -1)
    wv, S = decomp.safe_eigh(T)
    return wv[..., 0], S[..., :, 0]


# -- the whitened half-sweep --------------------------------------------------


def _nenv_step_right(NL, M):
    """Norm-network left-environment step: NL (a, k) absorbs M (k, d, k2)
    and its conjugate on the bra side -> (a2, k2)."""
    T = torch.einsum("ak,kdx->adx", NL, M)
    return torch.einsum("adx,ady->yx", T, torch.conj(M))


def _nenv_step_left(NR, M):
    """Norm-network right-environment step: NR (b, k) absorbs M (x, d, k)
    and its conjugate -> (x, y)."""
    T = torch.einsum("bk,xdk->bxd", NR, M)
    return torch.einsum("bxd,ydb->xy", T, torch.conj(M))


def _chol_and_inv(N, parity=None):
    """Batched Cholesky ``N = C C^H`` and the lower-triangular inverse
    ``C^-1``. Dead (zero-padded) directions, those with a diagonal entry
    at most ``1e-12`` of the trace, get a unit diagonal, and every matrix
    a shift of ``8 eps tr``, as in quimb_tpu. A matrix that is still not
    positive definite raises, naming ``parity`` and its batch entries
    (quimb_tpu's Cholesky returns NaN there)."""
    n = N.shape[-1]
    eye = torch.eye(n, dtype=N.dtype, device=N.device)
    diag = torch.diagonal(N, dim1=-2, dim2=-1).real
    tr = diag.sum(dim=-1, keepdim=True)
    dead = diag <= 1e-12 * tr.clamp(min=1e-30)
    Nf = N + dead.to(N.dtype)[..., :, None] * eye
    eps = torch.finfo(diag.dtype).eps
    Nf = Nf + (8 * eps * tr.clamp(min=1.0)).to(N.dtype)[..., None] * eye
    C, info = torch.linalg.cholesky_ex(Nf)
    if bool(info.any()):
        bad = torch.nonzero(info).flatten().tolist()
        raise torch.linalg.LinAlgError(
            f"the norm environments of parity {parity}, batch entries "
            f"{bad}, are not positive definite")
    Ci = torch.linalg.solve_triangular(C, eye.expand_as(Nf), upper=False)
    return C, Ci


def _edge_env(stack, edge, at_edge, idx):
    """The environments ``stack[idx]``, with ``edge`` where ``at_edge``
    (the chain's one-hot boundary environment)."""
    mask = at_edge.reshape(-1, *(1,) * edge.ndim)
    return torch.where(mask, edge, stack[idx])


def _jacobi_halfsweep(Ms, Ws, parity, ncv, max_bond, stride=2,
                      oversample=16, power_iters=3, omega=None):
    """One batched half-sweep over the bonds ``(i, i + 1)`` with
    ``i = parity, parity + stride, ...``, each solved in its whitened
    metric. ``omega`` is the (chi * d, max_bond + oversample) start of
    the randomized subspace (clipped to chi * d columns), shared by every
    bond; ``None`` draws it from a generator seeded ``17 + parity``.
    Returns the new stack and each bond's Ritz energy."""
    L, chi, d, _ = Ms.shape
    w = Ws.shape[1]
    dev, dtype = Ms.device, Ms.dtype
    rdt = Ms.real.dtype

    # the H and norm environments of every prefix and suffix
    lenv0 = torch.zeros((chi, w, chi), dtype=dtype, device=dev)
    lenv0[0, 0, 0] = 1.0
    renv0 = lenv0.clone()
    nl0 = torch.zeros((chi, chi), dtype=dtype, device=dev)
    nl0[0, 0] = 1.0
    nr0 = nl0.clone()
    lstack, rstack, nlstack, nrstack = [], [None] * L, [], [None] * L
    lenv, renv, NL, NR = lenv0, renv0, nl0, nr0
    for j in range(L):
        lenv = _env_step_right(lenv, torch.conj(Ms[j]), Ws[j], Ms[j])
        NL = _nenv_step_right(NL, Ms[j])
        lstack.append(lenv)
        nlstack.append(NL)
    for j in range(L - 1, -1, -1):
        renv = _env_step_left(renv, torch.conj(Ms[j]), Ws[j], Ms[j])
        NR = _nenv_step_left(NR, Ms[j])
        rstack[j], nrstack[j] = renv, NR
    lstack, rstack = torch.stack(lstack), torch.stack(rstack)
    nlstack, nrstack = torch.stack(nlstack), torch.stack(nrstack)

    # the parity's bonds (i, i + 1)
    iL = torch.arange(parity, L - 1, stride, device=dev)
    iR = iL + 1
    nb = iL.shape[0]
    at_left, at_right = iL == 0, iR == L - 1
    left, right = (iL - 1).clamp(min=0), (iR + 1).clamp(max=L - 1)
    Lb = _edge_env(lstack, lenv0, at_left, left)
    Rb = _edge_env(rstack, renv0, at_right, right)
    NLb = _edge_env(nlstack, nl0, at_left, left)
    NRb = _edge_env(nrstack, nr0, at_right, right)
    W1, W2 = Ws[iL], Ws[iR]

    # whitening: the ket-side bond index of theta transforms with C_L^H
    # (theta~ = C_L^H theta C_R^*), so that <theta|N_eff|theta> = |theta~|^2
    CL, CLi = _chol_and_inv(NLb, parity)
    CR, CRi = _chol_and_inv(NRb, parity)
    Lt = torch.einsum("nab,nbwk->nawk", CLi, Lb)
    Lt = torch.einsum("nawk,nck->nawc", Lt, torch.conj(CLi))
    Rt = torch.einsum("nab,nbwk->nawk", CRi, Rb)
    Rt = torch.einsum("nawk,nck->nawc", Rt, torch.conj(CRi))

    # the warm start in the whitened metric
    th0 = torch.einsum("nkpc,ncqr->nkpqr", Ms[iL], Ms[iR])
    th0 = torch.einsum("nka,nkpqr->napqr", torch.conj(CL), th0)
    th0 = torch.einsum("nkpqr,nre->nkpqe", th0, torch.conj(CR))

    LW1 = torch.einsum("nawk,nwxup->naxupk", Lt, W1)
    W2R = torch.einsum("nxyvq,nbyr->nxvqbr", W2, Rt)

    # batched Lanczos: a fixed basis of ncv vectors, reorthogonalised twice
    n = chi * d * d * chi
    v = th0.reshape(nb, n)
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp(min=1e-30)
    V = torch.zeros((nb, ncv, n), dtype=dtype, device=dev)
    V[:, 0] = v
    alpha = torch.zeros((nb, ncv), dtype=rdt, device=dev)
    beta = torch.zeros((nb, ncv), dtype=rdt, device=dev)
    for j in range(ncv):
        vj = V[:, j]
        hv = _batched_matvec(LW1, W2R, vj.reshape(nb, chi, d, d, chi))
        hv = hv.reshape(nb, n)
        alpha[:, j] = (torch.conj(vj) * hv).sum(dim=-1).real
        for _ in range(2):
            proj = torch.einsum("nkx,nx->nk", torch.conj(V), hv)
            hv = hv - torch.einsum("nkx,nk->nx", V, proj)
        b = torch.linalg.norm(hv, dim=-1)
        beta[:, j] = b.to(rdt)
        if j + 1 < ncv:
            V[:, j + 1] = torch.where((b > 1e-30)[:, None],
                                      hv / b[:, None].to(dtype), hv)
    ens, coeff = _batched_tridiag_eigvec(alpha, beta)
    th = torch.einsum("nk,nkx->nx", coeff.to(dtype), V)
    th = th / torch.linalg.norm(th, dim=-1, keepdim=True).clamp(min=1e-30)

    # rank-chi truncation in the whitened metric: an oversampled randomized
    # subspace, power iterations, and one small batched eigh for the
    # spectrum and rotation
    mat = th.reshape(nb, chi * d, d * chi)
    G = torch.einsum("nij,nkj->nik", mat, torch.conj(mat))
    kp = min(max_bond + oversample, chi * d)
    if omega is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(17 + parity)
        omega = torch.randn((chi * d, kp), generator=gen, dtype=rdt,
                            device=dev)
    Om = to_device(omega, device=dev)[:, :kp].to(dtype)
    Q = Om.expand(nb, chi * d, kp)
    for _ in range(max(power_iters, 1)):
        Q, _ = decomp.safe_qr(torch.einsum("nik,nkj->nij", G, Q))
    Bs = torch.einsum("nki,nkj->nij", torch.conj(Q), mat)
    wv, Rot = decomp.safe_eigh(torch.einsum("nij,nkj->nik", Bs,
                                            torch.conj(Bs)))
    wv, Rot = wv.flip(-1), Rot.flip(-1)
    s = torch.sqrt(wv.clamp(min=0.0))[..., :max_bond]
    U = torch.einsum("nik,nkj->nij", Q, Rot[..., :, :max_bond])
    # the rows s_i v_i^H by projection, with no 1 / s
    P = torch.einsum("nki,nkj->nij", torch.conj(U), mat)

    # un-whiten, with sqrt(s) absorbed on both sides; directions with
    # s == 0 are zeroed
    sq = torch.sqrt(s.clamp(min=1e-30))
    Uw = U * sq[..., None, :].to(dtype)
    Pw = P / sq[..., :, None].to(dtype) * (s > 0)[..., :, None].to(dtype)
    Mi = torch.einsum("nab,nbk->nak", torch.conj(CLi).transpose(1, 2),
                      Uw.reshape(nb, chi, d * max_bond))
    Mip = torch.einsum("nkb,nbr->nkr", Pw.reshape(nb, max_bond * d, chi),
                       torch.conj(CRi))
    Ms = Ms.clone()
    Ms[iL] = Mi.reshape(nb, chi, d, max_bond)
    Ms[iR] = Mip.reshape(nb, max_bond, d, chi)
    return Ms, ens


def _renormalize_stack(Ms):
    """Each tensor to unit Frobenius norm, then the stack scaled so that
    the state's norm is 1, the factor spread evenly over the sites.

    The whitened reassembly leaves neighbours with reciprocal magnitudes,
    which would spoil the norm environments' conditioning within a few
    sweeps. The norm pass divides by each step's trace and sums their logs,
    so it cannot overflow at any length; nothing is read to the host."""
    L = Ms.shape[0]
    tiny = torch.finfo(Ms.real.dtype).tiny
    fro = torch.sqrt((Ms.abs() ** 2).sum(dim=(1, 2, 3), keepdim=True))
    Ms = Ms / fro.clamp(min=tiny).to(Ms.dtype)
    NL = torch.zeros((Ms.shape[1], Ms.shape[1]), dtype=Ms.dtype,
                     device=Ms.device)
    NL[0, 0] = 1.0
    logn = torch.zeros((), dtype=Ms.real.dtype, device=Ms.device)
    for j in range(L):
        NL = _nenv_step_right(NL, Ms[j])
        tr = torch.trace(NL).real.clamp(min=tiny)
        NL = NL / tr.to(Ms.dtype)
        logn = logn + torch.log(tr)
    logn = logn + torch.log(NL[0, 0].real.clamp(min=tiny))
    return Ms * torch.exp(-logn / (2.0 * L)).to(Ms.dtype)


class JacobiDMRG:
    """Steady-state batched sweeps over a uniform stack, from a (partly
    converged) MPS / MPO pair, on the device of their tensors.

    ``sweep()`` runs one half-sweep per parity (``stride`` of them), each
    followed by :func:`_renormalize_stack`, and returns the mean of the
    bonds' Ritz energies (each the exact generalized Rayleigh quotient of
    its local solve). ``get_state()`` reads the MPS back out. ``omega``,
    a mapping from parity to a (chi * d, max_bond + oversample) matrix,
    replaces the seeded subspace starts (quimb_tpu's come from JAX's
    generator).
    """

    def __init__(self, psi, ham, max_bond, ncv=8, stride=2,
                 oversample=16, power_iters=3, omega=None):
        self.like = psi.copy()
        self.chi = int(max_bond)
        self.ncv = int(ncv)
        self.stride = int(stride)
        self.oversample = int(oversample)
        self.power_iters = int(power_iters)
        self.omega = omega
        Ms = mps_to_stack(psi, self.chi)
        Ws = mpo_to_padded_stack(ham)
        dtype = torch.promote_types(Ms.dtype, Ws.dtype)
        self.Ms = Ms.to(dtype)
        self.Ws = Ws.to(device=Ms.device, dtype=dtype)
        self.energies = []

    def sweep(self):
        ens_all = []
        for off in range(self.stride):
            self.Ms, ens = _jacobi_halfsweep(
                self.Ms, self.Ws, parity=off, ncv=self.ncv,
                max_bond=self.chi, stride=self.stride,
                oversample=self.oversample, power_iters=self.power_iters,
                omega=None if self.omega is None else self.omega[off],
            )
            self.Ms = _renormalize_stack(self.Ms)
            ens_all.append(ens)
        en = float(torch.cat(ens_all).mean())
        self.energies.append(en)
        return en

    def get_state(self):
        return stack_to_mps(self.Ms, self.like)
