"""Fused (batched) 2D SimpleUpdate sweeps.

Port of quimb_tpu's ``tensor/tn2d/su_fused.py``. The lattice is one
zero-padded site stack ``S (Lx, Ly, p, D, D, D, D)`` (axes p, u, r, d, l,
with u the bond towards (i+1, j) and r the bond towards (i, j+1): the
'urdlp' PEPS convention) plus the bond-gauge stacks ``GH (Lx, Ly-1, D)``
and ``GV (Lx-1, Ly, D)``. The bonds split into four vertex-disjoint
colour classes (horizontal even / odd, vertical even / odd); each class
updates all its bonds at once: gather, absorb the gauges, QR-reduce, gate,
truncated split, un-reduce, remove the gauges, scatter. A vertical class
is a horizontal one on the transposed lattice (i <-> j swaps u <-> r and
d <-> l). ``evolve(steps)`` is a loop of ``steps`` sweeps on the device
that reads no value back to the host; torch's convergence check of each
batched SVD waits for the device (two syncs a class update).

Edge sites carry size-``D`` virtual axes with only index 0 populated; a
mask per axis zeros what a rank-deficient QR or SVD completion could put
in the virtual rows after each class update, so the padding stays exact.

The truncated split of a class's batch of (kA p, p kB) matrices
(12 x 12, 112-128 of them, at D=3, p=2) takes :func:`_bond_svd`'s driver:
on CUDA cuSOLVER's batched Jacobi SVD (``gesvdj``, one launch for the
batch), checked and redone with ``gesvd`` where it fails to converge; on
the CPU LAPACK's. On an H100 at 16x16, D=3 (``chip_smoke.py`` phase 16,
``PERF.md``) one class's batch took 0.37-0.40 ms by ``gesvdj``,
123-144 ms by ``gesvd`` (which loops over the batch one matrix at a time)
and 4.1-4.6 ms by the matmul-only :func:`_topd_split`, whose values can
miss the SVD's where the top ones are close (4.5e-2 relative on a 5 x 5
lattice); ``gesvdj``'s values lay within 1.3e-12 of a host SVD's.
"""

import numpy as np
import torch

from ...ops import decomp
from ...ops.backend import to_host


def _mgs_cols(Y):
    """Orthonormalize the (few) trailing columns of ``Y`` by unrolled
    modified Gram-Schmidt — no QR, pure vector ops (the column count
    is the PEPS bond dimension, e.g. 3)."""
    cols = []
    for c in range(Y.shape[-1]):
        v = Y[..., :, c]
        for u in cols:
            v = v - u * (u.conj() * v).sum(-1, keepdim=True)
        v = v / torch.linalg.vector_norm(
            v, dim=-1, keepdim=True).clamp_min(1e-30)
        cols.append(v)
    return torch.stack(cols, dim=-1)


def _topd_split(M, D, iters=10):
    """Top-``D`` truncated split of batched small matrices ``M``
    (..., m, n) -> (U (..., m, D), s (..., D), V (..., D, n)) using
    Gram subspace iteration with MGS orthonormalization and a
    Newton-Schulz row cleanup — matmul-only."""
    G = M @ M.conj().transpose(-2, -1)
    Q = G[..., :, :D]
    for _ in range(iters):
        Q = _mgs_cols(G @ Q)
    B = Q.conj().transpose(-2, -1) @ M  # (D, n)
    s = torch.linalg.vector_norm(B, dim=-1)
    V = B / s[..., None].clamp_min(1e-30)
    # Newton-Schulz orthonormalization of V's rows (two steps of
    # V <- (3I - V V†)/2 V); also rotates U consistently through s
    eye = torch.eye(D, dtype=V.dtype, device=V.device)
    for _ in range(2):
        C = V @ V.conj().transpose(-2, -1)
        V = (1.5 * eye - 0.5 * C) @ V
    return Q, s.to(M.real.dtype), V


def _bond_svd(M):
    """Thin SVD of the batch ``M`` (..., m, n): on CUDA the batched
    ``gesvdj`` in ``M``'s dtype for a real batch, redone by ``gesvd`` (and
    counted in ``decomp.SVD_REDOS``) where it fails to converge, and
    ``decomp.safe_svd``'s complex route for a complex one; on the CPU
    LAPACK's driver."""
    if not M.is_cuda:
        return torch.linalg.svd(M, full_matrices=False)
    if M.is_complex():
        return decomp.safe_svd(M)
    return decomp._checked_gesvdj(M, M.dtype)


def _axis_masks(Lx, Ly, D, dtype, device):
    """Per-axis virtual-bond masks: mask[i/j, a] = 1 iff the bond
    exists there or a == 0 (the padded slot carrying the true
    tensor)."""
    mu = torch.ones((Lx, D), dtype=dtype, device=device)
    mu[Lx - 1, 1:] = 0.0  # u bond (i, j)-(i+1, j) absent at i = Lx-1
    md = torch.ones((Lx, D), dtype=dtype, device=device)
    md[0, 1:] = 0.0
    mr = torch.ones((Ly, D), dtype=dtype, device=device)
    mr[Ly - 1, 1:] = 0.0
    ml = torch.ones((Ly, D), dtype=dtype, device=device)
    ml[0, 1:] = 0.0
    return mu, mr, md, ml


def _apply_masks(S, masks):
    mu, mr, md, ml = masks
    S = S * mu[:, None, None, :, None, None, None]
    S = S * mr[None, :, None, None, :, None, None]
    S = S * md[:, None, None, None, None, :, None]
    S = S * ml[None, :, None, None, None, None, :]
    return S


def _h_class_update(S, GH, GV, U, o, smudge):
    """Update every horizontal bond (i, j)-(i, j+1) with j % 2 == o,
    batched over (Lx, n_bonds). ``S`` and ``GH`` are updated in place
    and returned with ``GV``.

    S : (Lx, Ly, p, D, D, D, D) site stack, axes (p, u, r, d, l)
    GH: (Lx, Ly-1, D) gauges on bonds (i, j)-(i, j+1)
    GV: (Lx-1, Ly, D) gauges on bonds (i, j)-(i+1, j)
    U : (Lx, nj, p, p, p, p) gates, axes (p_out_a, p_out_b, p_a, p_b)
    """
    Lx, Ly, p, D = S.shape[0], S.shape[1], S.shape[2], S.shape[3]
    gdt, dev = GH.dtype, GH.device

    ones_h = torch.ones((Lx, 1, D), dtype=gdt, device=dev)
    GHp = torch.cat([ones_h, GH, ones_h], dim=1)  # (Lx, Ly+1, D)
    ones_v = torch.ones((1, Ly, D), dtype=gdt, device=dev)
    GVp = torch.cat([ones_v, GV, ones_v], dim=0)  # (Lx+1, Ly, D)

    csA = slice(o, Ly - 1, 2)        # A-site columns j
    csB = slice(o + 1, Ly, 2)        # B-site columns j+1
    A = S[:, csA]
    B = S[:, csB]
    nj = A.shape[1]

    # environment gauges: u gauge of (i,j) = GVp[i+1, j], d = GVp[i, j],
    # r = GHp[i, j+1], l = GHp[i, j]
    uA = GVp[1:, csA] + smudge
    dA = GVp[:Lx, csA] + smudge
    lA = GHp[:, csA] + smudge
    uB = GVp[1:, csB] + smudge
    dB = GVp[:Lx, csB] + smudge
    rB = GHp[:, slice(o + 2, Ly + 1, 2)] + smudge
    sc = GH[:, csA]                  # central bond gauges (Lx, nj, D)

    # absorb environment gauges + sqrt of the central gauge
    A = A * uA[:, :, None, :, None, None, None]
    A = A * dA[:, :, None, None, None, :, None]
    A = A * lA[:, :, None, None, None, None, :]
    B = B * uB[:, :, None, :, None, None, None]
    B = B * dB[:, :, None, None, None, :, None]
    B = B * rB[:, :, None, None, :, None, None]
    sq = torch.sqrt(sc)
    A = A * sq[:, :, None, None, :, None, None]   # A's r axis (central)
    B = B * sq[:, :, None, None, None, None, :]   # B's l axis (central)

    # QR-reduce both sides over their environment axes
    # A: env (u, d, l), keep (p, r=central)
    At = A.permute(0, 1, 3, 5, 6, 2, 4)           # (x, y, u, d, l, p, r)
    Qa, Ra = torch.linalg.qr(At.reshape(Lx, nj, D * D * D, p * D))
    kA = Ra.shape[-2]
    Ra = Ra.reshape(Lx, nj, kA, p, D)
    # B: env (u, d, r), keep (p, l=central)
    Bt = B.permute(0, 1, 3, 5, 4, 2, 6)           # (x, y, u, d, r, p, l)
    Qb, Rb = torch.linalg.qr(Bt.reshape(Lx, nj, D * D * D, p * D))
    kB = Rb.shape[-2]
    Rb = Rb.reshape(Lx, nj, kB, p, D)

    # gate the two-site core
    theta = torch.einsum("xyipc,xyjqc->xyipqj", Ra, Rb)
    theta = torch.einsum("xyipqj,xyPQpq->xyiPQj", theta, U)
    M = theta.reshape(Lx, nj, kA * p, p * kB)

    # truncate back to D
    Um, s, Vm = _bond_svd(M)
    Um = Um[..., :, :D]
    s = s[..., :D]
    Vm = Vm[..., :D, :]
    s = s / torch.linalg.vector_norm(s, dim=-1, keepdim=True).clamp_min(
        1e-30)

    a_red = Um.reshape(Lx, nj, kA, p, D)
    b_red = Vm.reshape(Lx, nj, D, p, kB).permute(0, 1, 4, 3, 2)
    # (x, y, kB, p, D_new)

    # un-reduce
    Anew = torch.einsum("xyek,xykpc->xyepc", Qa, a_red)
    Anew = Anew.reshape(Lx, nj, D, D, D, p, D)     # (u, d, l, p, c)
    Anew = Anew.permute(0, 1, 5, 2, 6, 3, 4)
    Bnew = torch.einsum("xyek,xykpc->xyepc", Qb, b_red)
    Bnew = Bnew.reshape(Lx, nj, D, D, D, p, D)     # (u, d, r, p, c=l)
    Bnew = Bnew.permute(0, 1, 5, 2, 4, 3, 6)

    # remove the environment gauges
    Anew = Anew / uA[:, :, None, :, None, None, None]
    Anew = Anew / dA[:, :, None, None, None, :, None]
    Anew = Anew / lA[:, :, None, None, None, None, :]
    Bnew = Bnew / uB[:, :, None, :, None, None, None]
    Bnew = Bnew / dB[:, :, None, None, None, :, None]
    Bnew = Bnew / rB[:, :, None, None, :, None, None]

    # condition: unit-norm site tensors (reference condition_tensors)
    na = torch.linalg.vector_norm(Anew, dim=(2, 3, 4, 5, 6), keepdim=True)
    Anew = Anew / na.clamp_min(1e-30)
    nb = torch.linalg.vector_norm(Bnew, dim=(2, 3, 4, 5, 6), keepdim=True)
    Bnew = Bnew / nb.clamp_min(1e-30)

    S[:, csA] = Anew
    S[:, csB] = Bnew
    GH[:, csA] = s.to(GH.dtype)
    return S, GH, GV


def _transpose_lattice(S, GH, GV):
    """Swap the lattice axes: (i, j) -> (j, i), u <-> r, d <-> l."""
    St = S.permute(1, 0, 2, 4, 3, 6, 5)
    return St, GV.permute(1, 0, 2), GH.permute(1, 0, 2)


def _su_sweep(S, GH, GV, UHe, UHo, UVe, UVo, masks_h, masks_v, smudge):
    """One full simple-update sweep: H-even, H-odd, V-even, V-odd."""
    Ly = S.shape[1]
    S, GH, GV = _h_class_update(S, GH, GV, UHe, 0, smudge)
    if Ly > 2:
        S, GH, GV = _h_class_update(S, GH, GV, UHo, 1, smudge)
    S = _apply_masks(S, masks_h)

    S, GH, GV = _transpose_lattice(S, GH, GV)
    Lx_t = S.shape[1]  # transposed Ly = original Lx
    S, GH, GV = _h_class_update(S, GH, GV, UVe, 0, smudge)
    if Lx_t > 2:
        S, GH, GV = _h_class_update(S, GH, GV, UVo, 1, smudge)
    S = _apply_masks(S, masks_v)
    S, GH, GV = _transpose_lattice(S, GH, GV)
    return S, GH, GV


def _su_evolve(S, GH, GV, UHe, UHo, UVe, UVo, masks_h, masks_v, nsteps,
               smudge):
    """``nsteps`` fused sweeps, launched one after another on the device
    with no read back to the host."""
    for _ in range(int(nsteps)):
        S, GH, GV = _su_sweep(S, GH, GV, UHe, UHo, UVe, UVo, masks_h,
                              masks_v, smudge)
    return S, GH, GV


# --------------------------------------------------------------------------
# conversion between a PEPS (+ gauge dict) and the stacks
# --------------------------------------------------------------------------


def _site_axes(psi, i, j):
    """Map each index of psi[i, j] to one of 'purdl'."""
    t = psi[psi.site_tag(i, j)]
    pix = psi.site_ind(i, j)
    amap = {}
    for ax, ix in enumerate(t.inds):
        if ix == pix:
            amap["p"] = ax
            continue
        for role, coo in (("u", (i + 1, j)), ("r", (i, j + 1)),
                          ("d", (i - 1, j)), ("l", (i, j - 1))):
            if 0 <= coo[0] < psi.Lx and 0 <= coo[1] < psi.Ly:
                other = psi[psi.site_tag(*coo)]
                if ix in other.inds and role not in amap:
                    amap[role] = ax
                    break
    return t, amap


def peps_to_stacks(psi, gauges, D):
    """The (S, GH, GV) stacks of a PEPS + gauge dict, every bond
    zero-padded to width ``D``, built on the device of the PEPS's
    tensors (nothing is read back to the host)."""
    Lx, Ly = psi.Lx, psi.Ly
    p = psi.phys_dim()
    S = None
    for i in range(Lx):
        for j in range(Ly):
            t, amap = _site_axes(psi, i, j)
            a = t.data
            if S is None:
                S = torch.zeros((Lx, Ly, p, D, D, D, D), dtype=a.dtype,
                                device=a.device)
            # permute present axes into (p, u, r, d, l) order, then
            # insert size-1 axes for the missing (virtual) ones
            a = a.permute(*[amap[c] for c in "purdl" if c in amap])
            sh = iter(a.shape)
            full = [next(sh) if c in amap else 1 for c in "purdl"]
            S[i, j, :full[0], :full[1], :full[2], :full[3], :full[4]] = \
                a.reshape(full)

    rdt, dev = S.real.dtype, S.device
    GH = torch.zeros((Lx, max(Ly - 1, 0), D), dtype=rdt, device=dev)
    GV = torch.zeros((max(Lx - 1, 0), Ly, D), dtype=rdt, device=dev)
    for G, pairs in (
        (GH, [((i, j), (i, j + 1)) for i in range(Lx)
              for j in range(Ly - 1)]),
        (GV, [((i, j), (i + 1, j)) for i in range(Lx - 1)
              for j in range(Ly)]),
    ):
        for a, b in pairs:
            s = gauges.get(tuple(sorted((a, b))))
            i, j = a
            if s is None:
                # fresh bond: implicit identity gauge on the existing
                # bond width (get_state() then reproduces the input)
                G[i, j, :min(_bond_size(psi, a, b) or 1, D)] = 1.0
            else:
                s = torch.as_tensor(s).reshape(-1)[:D]
                G[i, j, :s.shape[0]] = s.to(device=dev, dtype=rdt)
    return S, GH, GV


def _bond_size(psi, a, b):
    ta = psi[psi.site_tag(*a)]
    tb = psi[psi.site_tag(*b)]
    for ix in ta.inds:
        if ix in tb.inds:
            return ta.ind_size(ix)
    return None


def stacks_to_peps(S, GH, GV, template):
    """Rebuild a PEPS (+ gauge dict) from the stacks, slicing away the
    virtual boundary axes; the arrays stay on the stacks' device."""
    from .core import PEPS

    Lx, Ly = template.Lx, template.Ly
    arrays = []
    for i in range(Lx):
        row = []
        for j in range(Ly):
            a = S[i, j].permute(1, 2, 3, 4, 0)  # (p, u, r, d, l) -> urdlp
            # slice away virtual axes
            sel = (
                slice(None) if i < Lx - 1 else 0,
                slice(None) if j < Ly - 1 else 0,
                slice(None) if i > 0 else 0,
                slice(None) if j > 0 else 0,
                slice(None),
            )
            row.append(a[sel].contiguous())
        arrays.append(row)

    psi = PEPS(
        arrays, shape="urdlp",
        site_ind_id=template.site_ind_id,
        site_tag_id=template.site_tag_id,
        x_tag_id=template._x_tag_id,
        y_tag_id=template._y_tag_id,
    )
    gauges = {}
    for i in range(Lx):
        for j in range(Ly - 1):
            gauges[((i, j), (i, j + 1))] = GH[i, j].clone()
    for i in range(Lx - 1):
        for j in range(Ly):
            gauges[((i, j), (i + 1, j))] = GV[i, j].clone()
    return psi, gauges


def host_gate_stack(ham, wheres, x, p, dtype):
    """Stack of ``expm(x * H_w)`` gates for a class of bonds, built on
    the host in float64 (tiny matrices; one transfer for the whole
    stack). ``x`` must be real (imaginary-time simple update)."""
    mats = []
    for w in wheres:
        H = np.asarray(to_host(ham.get_term(w)), dtype=np.float64)
        wv, V = np.linalg.eigh(H)
        U = (V * np.exp(float(x) * wv)) @ V.conj().T
        mats.append(U.reshape(p, p, p, p))
    return np.stack(mats).astype(dtype)


def class_gate_stacks(ham, Lx, Ly, x, p, dtype, device):
    """The four per-class gate stacks (UHe, UHo, UVe, UVo) on ``device``,
    each with batch shape matching the class's (rows, n_bonds) layout.
    ``dtype`` is a numpy dtype."""

    def h_stack(o):
        js = range(o, Ly - 1, 2)
        ws = [((i, j), (i, j + 1)) for i in range(Lx) for j in js]
        if not len(js):
            return np.zeros((Lx, 0, p, p, p, p), dtype=dtype)
        return host_gate_stack(ham, ws, x, p, dtype).reshape(
            Lx, len(js), p, p, p, p
        )

    def v_stack(o):
        # transposed lattice: rows = original columns j, bonds over i
        i_s = range(o, Lx - 1, 2)
        ws = [((i, j), (i + 1, j)) for j in range(Ly) for i in i_s]
        if not len(i_s):
            return np.zeros((Ly, 0, p, p, p, p), dtype=dtype)
        return host_gate_stack(ham, ws, x, p, dtype).reshape(
            Ly, len(i_s), p, p, p, p
        )

    return tuple(torch.as_tensor(g, device=device)
                 for g in (h_stack(0), h_stack(1), v_stack(0), v_stack(1)))
