"""Cyclic (periodic) DMRG: segmented sweeps with compressed ring closures.

Port of ``quimb_tpu/tensor/tn1d/dmrg_cyclic.py``, the engine behind
:class:`~.dmrg.DMRG` for a ring Hamiltonian of 40 sites or more. A ring's
site arrays are uniform, ``(chi, d, chi)`` for the state and
``(w, w, d, d)`` for the MPO (zero-padding an MPO bond is exact), and a
sweep visits the ring in segments. For each segment:

- the two wrap edges are gauged so that the complement's norm transfer is
  close to the identity (:meth:`CyclicSweeper._pseudo_canonize`, the
  reference's ``canonize_cyclic``);
- the segment is canonized toward the sweep's start by QR / LQ;
- the complement's H- and norm-transfer operators ("the long way round")
  are compressed by a randomized range sketch (:func:`_rsvd_transfer`)
  into closure seeds with a leading closure-rank axis ``s``; the sketch
  grows until the spectral tail is below the compression tolerance, and
  the rank is bucketed to a power of two (zero padding is exact);
- each two-site update solves the generalized problem (Heff, Neff) by
  Rayleigh-Ritz on a Lanczos basis (:func:`_local_solve_2site_cyc`), and
  the energy is the Rayleigh quotient through the closures.

quimb_tpu ``vmap``s the environment steps over ``s`` and ``lax.scan``s the
complement's stacked sites; here ``s`` is a leading batch axis of the
einsums and the complement a Python loop over its stacked sites. The
random sketches and the bond-growth noise come from a ``torch.Generator``
on the arrays' device seeded by ``CyclicSweeper(seed=)``, drawn in
float32 and cast, as quimb_tpu draws from ``jax.random`` in float32;
:func:`_rsvd_transfer` takes its sketch as ``omega`` and
:meth:`CyclicSweeper._grow_bond` its noise as ``pads``, so a caller can
supply quimb_tpu's draws. The host reads one vector of singular values
per sketch, to pick the closure rank, as quimb_tpu does.
"""

import numpy as np
import torch

from ...linalg.lanczos import _lanczos_basis
from ...ops import decomp
from ...ops.backend import to_host
from .dmrg import _env_step_left, _env_step_right, _split_2site


def _nenv_step_right(N, Ab, Ak):
    """Norm-network left-environment step: N (s,b,k), Ab (b,p,b2) the
    conjugated bra, Ak (k,p,k2) -> (s,b2,k2)."""
    T = torch.einsum("sbk,kdx->sbdx", N, Ak)
    return torch.einsum("sbdx,bda->sax", T, Ab)


def _nenv_step_left(N, Ab, Ak):
    """Norm-network right-environment step: N (s,b,k), Ab (a,p,b),
    Ak (x,p,k) -> (s,a,x)."""
    T = torch.einsum("sbk,xdk->sbxd", N, Ak)
    return torch.einsum("sbxd,adb->sax", T, Ab)


def _transfer_apply_right(X, Abs, Ws, Aks):
    """Apply the stacked complement's H-transfer to a batch of boundary
    triples X (S,b,w,k), absorbing its sites left to right (the steps of
    :mod:`.dmrg` broadcast the leading axis over the site tensors)."""
    for Ab, W, Ak in zip(Abs, Ws, Aks):
        X = _env_step_right(X, Ab, W, Ak)
    return X


def _transfer_apply_left(X, Abs, Ws, Aks):
    """The transpose application: absorb the sites right to left."""
    for t in range(Aks.shape[0] - 1, -1, -1):
        X = _env_step_left(X, Abs[t], Ws[t], Aks[t])
    return X


def _ntransfer_apply_right(X, Abs, Aks):
    for Ab, Ak in zip(Abs, Aks):
        X = _nenv_step_right(X, Ab, Ak)
    return X


def _ntransfer_apply_left(X, Abs, Aks):
    for t in range(Aks.shape[0] - 1, -1, -1):
        X = _nenv_step_left(X, Abs[t], Aks[t])
    return X


def _rsvd_transfer(apply_T, apply_Tt, shape_in, shape_out, omega, q=1):
    """Randomized SVD of a linear transfer map known only by its batched
    action ``apply_T`` (the column map ``x -> T x``: for a ring's
    complement, the right-to-left environment pass) and the plain
    transpose action ``apply_Tt`` (the left-to-right pass): the
    Halko-Martinsson-Tropp range sketch, the reference's lazy ``isvd``.
    ``omega`` (ks, *shape_in) is the sketch's start, cast to the
    operands' dtype. Returns (U (Dout, ks), s, VH (ks, Din)); the caller
    picks the rank."""
    Din = int(np.prod(shape_in))
    Dout = int(np.prod(shape_out))
    ks = omega.shape[0]
    Y = apply_T(omega)                                # (ks, *shape_out)
    for _ in range(q):
        Z = torch.conj(apply_Tt(torch.conj(Y)))       # T^H Y
        Y = apply_T(Z)
    # an orthonormal basis of the range
    Q, _ = torch.linalg.qr(torch.reshape(Y, (ks, Dout)).T)   # (Dout, ks)
    # B = Q^H T = (T^H Q)^H, with T^H u = conj(T^t conj(u))
    Zt = torch.conj(apply_Tt(torch.conj(
        torch.reshape(Q.T, (ks, *shape_out)))))        # (ks, *shape_in)
    B = torch.conj(torch.reshape(Zt, (ks, Din)))       # = Q^H T
    Ub, s, VH = decomp.safe_svd(B)
    return Q @ Ub, s, VH


def _local_solve_2site_cyc(L, W1, W2, R, NL, NR, theta0, ncv, restarts,
                           fudge=1e-12):
    """Ground state of the ring's two-site effective pencil (Heff, Neff).

    The environments carry a leading closure-rank axis, contracted
    between the ring's two ends, and the effective norm is not the
    identity (a ring cannot be made fully canonical; the reference solves
    the generalized problem by LOBPCG). Here a Krylov basis is built with
    Heff, both operators are projected onto it, and the small generalized
    problem is solved by folding with ``Nm^{-1/2}`` (eigenvalues below
    ``fudge`` clipped). The returned theta is normalized in the Neff
    metric, so the ring state stays normalized; the energy is the
    Rayleigh quotient. Both come back on the device."""
    LW1 = torch.einsum("sawk,wxup->saxupk", L, W1)
    W2R = torch.einsum("xyvq,sbyr->sxvqbr", W2, R)

    def matvec(th):
        T = torch.einsum("...kpqr,saxupk->...sauxqr", th, LW1)
        return torch.einsum("...sauxqr,sxvqbr->...auvb", T, W2R)

    def nmatvec(th):
        T = torch.einsum("tbk,...kpqr->...tbpqr", NL, th)
        return torch.einsum("...tbpqr,tcr->...bpqc", T, NR)

    def vdot(a, b):
        return torch.sum(torch.conj(a) * b)

    shape = theta0.shape
    v = theta0 / torch.linalg.norm(torch.reshape(theta0, (-1,)))
    for _ in range(restarts):
        V, _, _ = _lanczos_basis(matvec, v, ncv)       # V (ncv, n)
        # project the pencil onto the Krylov basis
        Vs = torch.reshape(V, (ncv, *shape))
        HV = torch.reshape(matvec(Vs), (ncv, -1))
        NV = torch.reshape(nmatvec(Vs), (ncv, -1))
        Hm = torch.conj(V) @ HV.T
        Nm = torch.conj(V) @ NV.T
        Hm = (Hm + torch.conj(Hm.T)) / 2
        Nm = (Nm + torch.conj(Nm.T)) / 2
        # fold: Nm^{-1/2} Hm Nm^{-1/2}, the null space clipped
        wn, Un = torch.linalg.eigh(Nm)
        wn = torch.clamp(wn.real, min=fudge)
        F = Un * (wn ** -0.5).to(Un.dtype)[None, :]
        Hf = torch.conj(F.T) @ Hm @ F
        Hf = (Hf + torch.conj(Hf.T)) / 2
        _, Uh = torch.linalg.eigh(Hf)
        c = (F @ Uh[:, 0]).to(V.dtype)
        v = torch.reshape(c @ V, shape)
        # normalize in the Neff metric
        den = vdot(v, nmatvec(v)).real
        v = v / torch.sqrt(torch.where(den > 0, den, torch.ones_like(den)))

    num = vdot(v, matvec(v)).real
    den = vdot(v, nmatvec(v)).real
    return num / den, v


def _ring_quotient(lenv, renv0, nlenv, nrenv0):
    """The whole ring's <H>/<1> from a segment's absorbed left
    environments and the closure's right seeds: sum over s of the
    elementwise products."""
    e = torch.einsum("sbwk,sbwk->", lenv, renv0).real
    n = torch.einsum("sbk,sbk->", nlenv, nrenv0).real
    return e / n


def _gauge_from_edge_density(E, inv_tol):
    """Split a (symmetrized) edge density matrix E (D, D) into x with
    x^H x = E and its inverse, singular directions below ``inv_tol``
    dropped (the reference's ``canonize_cyclic`` eigh split). The overall
    phase of E is fixed first: SVD factors carry an arbitrary phase, and
    the eigenvalue clip would annihilate a negated PSD matrix."""
    tr = torch.trace(E)
    atr = torch.abs(tr)
    ph = tr / torch.where(atr > 0, atr, torch.ones_like(atr))
    E = E * torch.conj(ph)
    E = (E + torch.conj(E.T)) / 2
    lam, V = torch.linalg.eigh(E)
    sq = torch.sqrt(torch.clamp(lam.real, min=0.0))
    x = sq.to(E.dtype)[:, None] * torch.conj(V.T)
    inv = torch.where(sq > inv_tol,
                      1.0 / torch.where(sq > 0, sq, torch.ones_like(sq)),
                      torch.zeros_like(sq))
    xinv = V * inv.to(E.dtype)[None, :]
    return x, xinv


def _apply_gauge_left_bond(x, A):
    """A (l,p,r) -> x @ A on the left bond."""
    return torch.einsum("ij,jpk->ipk", x, A)


def _apply_gauge_right_bond(A, x):
    """A (l,p,r) -> A @ x on the right bond."""
    return torch.einsum("ipj,jk->ipk", A, x)


def _theta_2site(A1, A2):
    return torch.einsum("kpc,cqr->kpqr", A1, A2)


def _lrp_inds(tn, i, phys):
    """Site ``i``'s bond indices to its ring neighbours, left then
    right."""
    L = tn.L
    t = tn[tn.site_tag(i)]
    tl = tn[tn.site_tag((i - 1) % L)]
    tr = tn[tn.site_tag((i + 1) % L)]
    lix = [ix for ix in t.inds if ix not in phys and ix in tl.inds]
    rix = [ix for ix in t.inds if ix not in phys and ix in tr.inds]
    return t, lix, rix


def cyclic_mps_arrays(psi, chi=None):
    """The ``(l, p, r)`` site arrays of a cyclic MPS, zero-padded to one
    bond dimension ``chi`` (default: the largest bond)."""
    L = psi.L
    if L < 3:
        raise ValueError("cyclic array form needs L >= 3")
    out = []
    for i in range(L):
        p = psi.site_ind(i)
        t, lix, rix = _lrp_inds(psi, i, (p,))
        out.append(t.transpose(*lix, p, *rix).data)
    if chi is None:
        chi = max(max(a.shape[0], a.shape[2]) for a in out)
    padded = []
    for a in out:
        b = a.new_zeros((chi, a.shape[1], chi))
        b[: a.shape[0], :, : a.shape[2]] = a
        padded.append(b)
    return padded


def cyclic_mpo_arrays(ham):
    """The ``(wl, wr, u, d)`` site arrays of a cyclic MPO, zero-padded to
    one MPO bond (exact)."""
    out = []
    for i in range(ham.L):
        u, d = ham.upper_ind(i), ham.lower_ind(i)
        t, lix, rix = _lrp_inds(ham, i, (u, d))
        out.append(t.transpose(*lix, *rix, u, d).data)
    w = max(max(a.shape[0], a.shape[1]) for a in out)
    padded = []
    for a in out:
        b = a.new_zeros((w, w, *a.shape[2:]))
        b[: a.shape[0], : a.shape[1]] = a
        padded.append(b)
    return padded


def cyclic_arrays_to_mps(arrays, like):
    """Uniform ``(l, p, r)`` arrays -> a cyclic MPS with the index and
    tag ids of ``like``."""
    from .core import MatrixProductState

    return MatrixProductState(
        [a.permute(0, 2, 1) for a in arrays], shape="lrp", cyclic=True,
        site_ind_id=like._site_ind_id, site_tag_id=like._site_tag_id,
    )


def _closure_seeds(U, s, VH, r, kh, shape):
    """Rank-``r`` closure seeds from a sketch's factors, the rank bucketed
    to the next power of two (at most ``kh``) with zero rows: the left
    seed ``sqrt(s) VH`` and the right seed ``(U sqrt(s))^T``."""
    rp = min(1 << (r - 1).bit_length(), kh)
    keep = torch.arange(rp, device=s.device) < r
    sq = torch.sqrt(torch.where(keep, s[:rp], torch.zeros_like(s[:rp])))
    sq = sq.to(U.dtype)
    lseed = torch.reshape(sq[:, None] * VH[:rp], (rp, *shape))
    rseed = torch.reshape((U[:, :rp] * sq[None, :]).T, (rp, *shape))
    return lseed, rseed


class CyclicSweeper:
    """Two-site DMRG sweeps of a ring on its uniform arrays.

    Parameters
    ----------
    Ws : list of (w, w, d, d) tensors
        The cyclic MPO's site arrays, zero-padded to one MPO bond.
    As : list of (chi, d, chi) tensors
        The cyclic MPS's site arrays, one bond dimension.
    opts : dict
        DMRG's options (:func:`~.dmrg.get_default_opts`); the
        ``periodic_*`` entries drive the closure compressions and
        ``bond_expand_rand_strength`` the bond growth.
    seed : int
        The seed of the generator of the sketches and the growth noise.
    """

    def __init__(self, Ws, As, opts, seed=0):
        self.L = len(As)
        self._W = list(Ws)
        self._A = list(As)
        self.opts = opts
        self._gen = torch.Generator(device=self._A[0].device)
        self._gen.manual_seed(seed)
        #: the H closure's rank of every segment visited
        self.bond_sizes = []
        #: host reads of singular values (one per sketch)
        self.host_reads = 0

    # -- random draws -------------------------------------------------------

    def _normal(self, shape):
        return torch.randn(shape, generator=self._gen, dtype=torch.float32,
                           device=self._A[0].device)

    def _draw_sketch(self, shape):
        """One sketch start, float32 standard normal."""
        return self._normal(shape)

    def _draw_pads(self, shapes):
        """The growth noise of every site, float32 standard normal."""
        return [self._normal(shape) for shape in shapes]

    # -- helpers ------------------------------------------------------------

    @property
    def chi(self):
        return self._A[0].shape[0]

    def _grow_bond(self, chi_new, pads=None):
        """Pad every site array to the larger bond ``chi_new``, adding
        noise of strength ``bond_expand_rand_strength`` so that the gauges
        stay invertible. ``pads`` (one (chi_new, d, chi_new) array per
        site) is the noise before its scaling, drawn by default."""
        chi = self.chi
        if chi_new <= chi:
            return
        eps = self.opts.get("bond_expand_rand_strength", 1e-6)
        if pads is None:
            pads = self._draw_pads([(chi_new, A.shape[1], chi_new)
                                    for A in self._A])
        for i, A in enumerate(self._A):
            new = pads[i].to(A.dtype) * eps
            new[:chi, :, :chi] += A
            self._A[i] = new

    def _stack(self, sites, arrs):
        return torch.stack([arrs[j % self.L] for j in sites])

    def _complement_stacks(self, comp):
        Aks = self._stack(comp, self._A)
        return torch.conj(Aks), self._stack(comp, self._W), Aks

    def _sketch(self, apply_T, apply_Tt, shape, k_sketch):
        """The randomized SVD of a square transfer map on ``shape``, with
        a fresh sketch of rank ``k_sketch`` (capped), its singular values
        read to the host once."""
        ks = min(k_sketch, int(np.prod(shape)))
        omega = self._draw_sketch((ks, *shape)).to(self._A[0].dtype)
        U, s, VH = _rsvd_transfer(apply_T, apply_Tt, shape, shape, omega,
                                  q=1)
        self.host_reads += 1
        return U, s, VH, to_host(s).astype(np.float64)

    # -- segment machinery --------------------------------------------------

    def _pseudo_canonize(self, s0, s1, comp):
        """Gauge the two wrap edges so that the complement's norm transfer
        is close to the identity (the reference's ``canonize_cyclic``)."""
        L, chi = self.L, self.chi
        Aks = self._stack(comp, self._A)
        Abs = torch.conj(Aks)
        U, s, VH, _ = self._sketch(
            lambda X: _ntransfer_apply_left(X, Abs, Aks),
            lambda X: _ntransfer_apply_right(X, Abs, Aks),
            (chi, chi), min(8, chi * chi))
        inv_tol = self.opts.get("periodic_canonize_inv_tol", 1e-10)
        # the dominant rank-1 edge densities: the V side lives at the
        # segment's left edge (left environments' row space), the U side
        # at its right edge
        EL = torch.reshape(VH[0, :] * s[0].to(VH.dtype), (chi, chi))
        ER = torch.reshape(U[:, 0], (chi, chi))
        x, xinv = _gauge_from_edge_density(EL, inv_tol)
        # the left edge: bond (s0 - 1 | s0)
        self._A[s0 % L] = _apply_gauge_left_bond(x, self._A[s0 % L])
        self._A[(s0 - 1) % L] = _apply_gauge_right_bond(
            self._A[(s0 - 1) % L], xinv)
        y, yinv = _gauge_from_edge_density(ER, inv_tol)
        # the right edge: bond (s1 | s1 + 1). The complement's in-edge
        # density transforms as conj(G) ER G^T with A[s1+1] <- G A[s1+1],
        # so G = y^{-T} makes it the identity
        G, Ginv = yinv.T, y.T
        self._A[(s1 + 1) % L] = _apply_gauge_left_bond(
            G, self._A[(s1 + 1) % L])
        self._A[s1 % L] = _apply_gauge_right_bond(self._A[s1 % L], Ginv)

    def _canonize_segment(self, sites, toward="left"):
        """Make the segment's interior canonical toward the sweep's start
        by QR / LQ moves."""
        L = self.L
        if toward == "left":
            # right-canonize sites[-1] .. sites[1]
            for j in reversed(range(1, len(sites))):
                i, ip = sites[j] % L, sites[j - 1] % L
                chi, d, chir = self._A[i].shape
                # LQ by QR of the transpose
                Q, R = torch.linalg.qr(
                    torch.reshape(self._A[i], (chi, d * chir)).T)
                self._A[i] = torch.reshape(Q.T, (chi, d, chir))
                self._A[ip] = _apply_gauge_right_bond(self._A[ip], R.T)
            return
        for j in range(len(sites) - 1):
            i, inx = sites[j] % L, sites[j + 1] % L
            chi, d, chir = self._A[i].shape
            Q, R = torch.linalg.qr(torch.reshape(self._A[i],
                                                 (chi * d, chir)))
            self._A[i] = torch.reshape(Q, (chi, d, chir))
            self._A[inx] = _apply_gauge_left_bond(R, self._A[inx])

    def _compress_closures(self, comp):
        """Compress the complement's H- and norm-transfer operators into
        low-rank boundary seeds (lenv0, renv0, nlenv0, nrenv0).

        The complement's column map is its right-to-left pass: the V side
        of ``Comp = U S V^H`` seeds the segment's left environments, the U
        side its right ones. Each sketch doubles until its last singular
        value is below the tolerance relative to its first, or its cap."""
        chi, w = self.chi, self._W[0].shape[0]
        Abs, Ws, Aks = self._complement_stacks(comp)
        eps_h = self.opts.get("periodic_compress_tol", 1e-6)
        eps_n = self.opts.get("periodic_compress_norm_eps", 1e-6)
        mb = self.opts.get("periodic_compress_max_bond", -1)
        kmax = min(chi * w * chi, mb if (mb and mb > 0) else 128)

        kh = min(16, kmax)
        while True:
            U, s, VH, s_h = self._sketch(
                lambda X: _transfer_apply_left(X, Abs, Ws, Aks),
                lambda X: _transfer_apply_right(X, Abs, Ws, Aks),
                (chi, w, chi), kh)
            if s_h[-1] <= eps_h * max(s_h[0], 1e-300) or kh >= kmax:
                break
            kh = min(2 * kh, kmax)
        r = max(1, int(np.sum(s_h > eps_h * max(s_h[0], 1e-300))))
        if mb and mb > 0:
            r = min(r, mb)
        self.bond_sizes.append(r)
        lenv0, renv0 = _closure_seeds(U, s, VH, r, kh, (chi, w, chi))

        knmax = min(chi * chi, 64)
        kn = min(8, knmax)
        while True:
            Un, sn, VHn, sn_h = self._sketch(
                lambda X: _ntransfer_apply_left(X, Abs, Aks),
                lambda X: _ntransfer_apply_right(X, Abs, Aks),
                (chi, chi), kn)
            if sn_h[-1] <= eps_n * max(sn_h[0], 1e-300) or kn >= knmax:
                break
            kn = min(2 * kn, knmax)
        rn = max(1, int(np.sum(sn_h > eps_n * max(sn_h[0], 1e-300))))
        nlenv0, nrenv0 = _closure_seeds(Un, sn, VHn, rn, kn, (chi, chi))
        return lenv0, renv0, nlenv0, nrenv0

    # -- sweeping -----------------------------------------------------------

    def _segments(self, direction):
        """The segments (s0, s1) of a sweep: explicit sites s0..s1
        inclusive (s1's tensor is the wrap partner of the last block),
        positions s0..s1-1, of ``periodic_segment_size`` of the ring each;
        the complement always keeps at least one site."""
        L = self.L
        frac = self.opts.get("periodic_segment_size", 0.5)
        m = int(L * frac) if isinstance(frac, float) else int(frac)
        m = max(2, min(m, L - 2))
        segs = []
        s0 = 0
        while s0 < L:
            s1 = s0 + m
            if L - s1 < 2:  # absorb a short tail
                s1 = L
            segs.append((s0, s1))
            s0 = s1
        if direction == "L":
            segs = segs[::-1]
        return segs

    def sweep(self, direction="R", max_bond=None, cutoff=0.0, ncv=8,
              restarts=1, method="svd"):
        """One cyclic sweep. Returns the last update's Rayleigh quotient
        (the whole ring's, through the compressed closures) as a float."""
        if max_bond is not None:
            self._grow_bond(max_bond)
        L, chi = self.L, self.chi
        energy = None
        solve = dict(ncv=ncv, restarts=restarts)
        split = dict(max_bond=chi, cutoff=cutoff, method=method)

        for (s0, s1) in self._segments(direction):
            comp = [(s1 + 1 + j) % L for j in range((s0 + L - s1 - 1) % L)]
            sites = [j % L for j in range(s0, s1 + 1)]
            if not comp:
                # the segment covers the whole ring: keep the wrap pair
                # as the complement by shrinking the segment by two sites
                comp = [(s1 - 1) % L, s1 % L]
                sites = [j % L for j in range(s0, s1 - 1)]
                s1 = s1 - 2
            self._pseudo_canonize(s0, s1, comp)
            self._canonize_segment(
                sites, toward="left" if direction == "R" else "right")
            lenv0, renv0, nlenv0, nrenv0 = self._compress_closures(comp)

            if direction == "R":
                # the right environments of every position
                renvs, nrenvs = {s1: renv0}, {s1: nrenv0}
                for j in reversed(range(s0 + 1, s1)):
                    A = self._A[(j + 1) % L]
                    renvs[j] = _env_step_left(
                        renvs[j + 1], torch.conj(A), self._W[(j + 1) % L], A)
                    nrenvs[j] = _nenv_step_left(nrenvs[j + 1],
                                                torch.conj(A), A)
                lenv, nlenv = lenv0, nlenv0
                for p in range(s0, s1):
                    i, i1 = p % L, (p + 1) % L
                    energy, v = _local_solve_2site_cyc(
                        lenv, self._W[i], self._W[i1], renvs[p + 1], nlenv,
                        nrenvs[p + 1], _theta_2site(self._A[i], self._A[i1]),
                        **solve)
                    A1, A2, _ = _split_2site(v, absorb="right", **split)
                    self._A[i], self._A[i1] = A1, A2
                    lenv = _env_step_right(lenv, torch.conj(A1),
                                             self._W[i], A1)
                    nlenv = _nenv_step_right(nlenv, torch.conj(A1), A1)
            else:
                lenvs, nlenvs = {s0: lenv0}, {s0: nlenv0}
                for j in range(s0 + 1, s1):
                    A = self._A[(j - 1) % L]
                    lenvs[j] = _env_step_right(
                        lenvs[j - 1], torch.conj(A), self._W[(j - 1) % L], A)
                    nlenvs[j] = _nenv_step_right(nlenvs[j - 1],
                                                 torch.conj(A), A)
                renv, nrenv = renv0, nrenv0
                for p in reversed(range(s0, s1)):
                    i, i1 = p % L, (p + 1) % L
                    energy, v = _local_solve_2site_cyc(
                        lenvs[p], self._W[i], self._W[i1], renv, nlenvs[p],
                        nrenv, _theta_2site(self._A[i], self._A[i1]),
                        **solve)
                    A1, A2, _ = _split_2site(v, absorb="left", **split)
                    self._A[i], self._A[i1] = A1, A2
                    renv = _env_step_left(renv, torch.conj(A2),
                                            self._W[i1], A2)
                    nrenv = _nenv_step_left(nrenv, torch.conj(A2), A2)

        return float(energy)
