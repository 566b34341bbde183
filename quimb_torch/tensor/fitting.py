"""Distances between tensor networks, and fitting one network to another
(ALS, tree-gauge sweeps, autodiff).

Port of quimb_tpu's ``tensor/fitting.py`` (reference
``quimb/tensor/fitting.py``: ``tensor_network_distance`` :9, the autodiff
fit :156, the ALS fit and its solvers :297, :451,
``conjugate_gradient`` :257, ``tensor_network_fit_tree`` :608). Each ALS
update is one small solve with many right-hand sides on the device of
the network's tensors; a sweep reads its distance to the host once, as
quimb_tpu's does.
"""

import math

import torch

from .core import Tensor, TensorNetwork
from .networking import compute_hierarchical_ordering, get_path_between_tids


def conjugate_gradient(A, b, x0=None, tol=1e-5, maxiter=1000):
    """CG solve of ``A x = b`` for a hermitian (complex allowed) matrix;
    a matrix ``b`` is solved column by column, all columns together
    (reference ``conjugate_gradient`` fitting.py:257). A loop of
    ``maxiter`` iterations with quimb_tpu's convergence mask: once the
    largest residual norm is below ``tol`` the later iterations change
    nothing, and no iteration reads the device."""
    if x0 is None:
        x0 = torch.zeros_like(b)

    def vdot_b(u, v):
        return torch.sum(u.conj() * v, dim=0, keepdim=True)

    x = x0
    r = b - A @ x0
    p = r
    rs = vdot_b(r, r)
    for _ in range(maxiter):
        active = torch.max(torch.sqrt(torch.abs(rs))) >= tol
        Ap = A @ p
        denom = vdot_b(p, Ap)
        alpha = rs / torch.where(denom == 0, torch.ones_like(denom), denom)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        rs_new = vdot_b(r_new, r_new)
        beta = rs_new / torch.where(rs == 0, torch.ones_like(rs), rs)
        p_new = r_new + beta * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        rs = torch.where(active, rs_new, rs)
    return x


def _as_tn(x):
    if isinstance(x, Tensor):
        return TensorNetwork((x,), virtual=True, check_collisions=False)
    return x


def _overlap(tnA, tnB, **contract_opts):
    """<B|A> as a host complex number."""
    return complex((tnA | tnB.conj(mangle_inner=True)).contract(
        ..., **contract_opts))


def tensor_network_distance(tnA, tnB, xAA=None, xAB=None, xBB=None,
                            method="auto", normalized=False,
                            **contract_opts):
    """The Frobenius distance ``|A - B|`` of two networks as vectors over
    their outer indices (reference ``tensor_network_distance``
    fitting.py:9): ``sqrt(<A|A> - 2 Re<A|B> + <B|B>)``."""
    tnA, tnB = _as_tn(tnA), _as_tn(tnB)
    if set(tnA.outer_inds()) != set(tnB.outer_inds()):
        raise ValueError("can only compute distance between networks with "
                         "matching outer indices")
    xAA = _overlap(tnA, tnA, **contract_opts) if xAA is None else xAA
    xAB = _overlap(tnA, tnB, **contract_opts) if xAB is None else xAB
    xBB = _overlap(tnB, tnB, **contract_opts) if xBB is None else xBB
    d = abs(complex(xAA) - 2 * complex(xAB).real + complex(xBB)) ** 0.5
    if normalized:
        d = d / ((abs(complex(xAA)) ** 0.5 + abs(complex(xBB)) ** 0.5) / 2)
    return d


def _mangled_bra(tn_fit, tid, solve_inds, star, outer):
    """The conjugate of ``tn_fit`` without tensor ``tid``, the hole's
    solve indices starred and the other inner indices mangled."""
    bra = tn_fit.conj()
    bra._pop_tensor(tid)
    bra.reindex_({ix: star[ix] for ix in solve_inds if ix in bra.ind_map})
    bra.mangle_inner_(which=[ix for ix in bra.inner_inds()
                             if ix not in outer and ix not in star.values()])
    return bra


def tensor_network_fit_als(tn, tn_target, tags=None, steps=100, tol=1e-9,
                           solver="solve", solver_maxiter=4,
                           enforce_pos=False, pos_smudge=1e-15,
                           inplace=False, progbar=False, **contract_opts):
    """Fit ``tn`` to ``tn_target`` by alternating least squares, tensor by
    tensor (reference ``tensor_network_fit_als`` fitting.py:297).

    For each tensor the normal equations ``N t = b`` come from its
    environments in <A|A> and <A|B> (its outer indices act as batch
    dimensions), solved by ``solver``: ``'solve'`` (dense, with a tiny
    trace-scaled ridge), ``'cg'`` (:func:`conjugate_gradient` from the
    current tensor, ``solver_maxiter`` iterations), ``'lstsq'`` (least
    squares through the pseudo-inverse, robust to a singular ``N``) or
    ``'eigh'`` (eigendecomposition with the spectrum clipped at
    ``pos_smudge``, as ``enforce_pos`` does)."""
    tn_fit = tn if inplace else tn.copy()
    tn_target = _as_tn(tn_target)
    outer = set(tn_fit.outer_inds())
    tids = (tuple(tn_fit.tensor_map) if tags is None
            else tuple(tn_fit._get_tids_from_tags(tags, "any")))
    xBB = _overlap(tn_target, tn_target, **contract_opts)

    old_d = None
    for step in range(steps):
        for tid in tids:
            t = tn_fit.tensor_map[tid]
            solve_inds = [ix for ix in t.inds if ix not in outer]
            batch_inds = [ix for ix in t.inds if ix in outer]
            star = {ix: ix + "__star__" for ix in solve_inds}
            dl = math.prod(t.ind_size(ix) for ix in solve_inds)
            db = math.prod(t.ind_size(ix) for ix in batch_inds)

            ket = tn_fit.copy()
            ket._pop_tensor(tid)
            envN = ket & _mangled_bra(tn_fit, tid, solve_inds, star, outer)
            tN = envN.contract(
                ..., output_inds=(*(star[ix] for ix in solve_inds),
                                  *solve_inds),
                preserve_tensor=True, **contract_opts)
            Nmat = tN.data.reshape(dl, dl)

            envB = (_mangled_bra(tn_fit, tid, solve_inds, star, outer)
                    & tn_target.copy())
            tb = envB.contract(
                ..., output_inds=(*(star[ix] for ix in solve_inds),
                                  *batch_inds),
                preserve_tensor=True, **contract_opts)
            bmat = tb.data.reshape(dl, db)

            if enforce_pos or solver == "eigh":
                w, V = torch.linalg.eigh(Nmat)
                w = torch.clamp(w.real, min=pos_smudge)
                x = V @ ((V.conj().T @ bmat) / w[:, None].to(bmat.dtype))
            elif solver == "cg":
                x0 = t.transpose(*solve_inds, *batch_inds).data.reshape(
                    dl, db).to(bmat.dtype)
                x = conjugate_gradient(Nmat, bmat, x0=x0,
                                       maxiter=solver_maxiter)
            elif solver == "lstsq":
                x = torch.linalg.pinv(Nmat) @ bmat
            else:
                eps = pos_smudge * abs(complex(torch.trace(Nmat))) / max(dl,
                                                                          1)
                x = torch.linalg.solve(
                    Nmat + eps * torch.eye(dl, dtype=Nmat.dtype,
                                           device=Nmat.device), bmat)
            new = x.reshape(*(t.ind_size(ix) for ix in solve_inds),
                            *(t.ind_size(ix) for ix in batch_inds))
            t.modify(data=new, inds=(*solve_inds, *batch_inds))

        d = tensor_network_distance(tn_fit, tn_target, xBB=xBB,
                                    **contract_opts)
        if progbar:
            print(f"als step {step}: distance {d}")
        if old_d is not None and abs(old_d - d) < tol:
            break
        old_d = d
    return tn_fit


def tensor_network_fit_tree(tn, tn_target, tags=None, steps=100, tol=1e-9,
                            ordering=None, xBB=None, istree=True,
                            inplace=False, progbar=False, **contract_opts):
    """Fit ``tn``, a tree (one path between any two tensors), to
    ``tn_target`` (reference ``tensor_network_fit_tree`` fitting.py:608).

    With the canonical center at a tensor its environment in <A|A> is the
    identity, so the optimal update is the hole of <A|B>: no normal
    matrix is solved. The center moves between consecutive tensors along
    the tree's paths. ``istree=False`` canonizes around each tensor
    instead, which is approximate on a loopy ``tn``."""
    tn_target = _as_tn(tn_target)
    if xBB is None:
        xBB = abs(_overlap(tn_target, tn_target, **contract_opts))
    # the conjugate, so that the holes of <A|B> are the updates
    tn_fit = tn.conj(inplace=inplace)
    tnAB = tn_fit & tn_target.copy()

    if ordering is None:
        ordering = compute_hierarchical_ordering(tn_fit)
        if tags is not None:
            tids = set(tn_fit._get_tids_from_tags(tags, "any"))
            ordering = tuple(tid for tid in ordering if tid in tids)

    env_contractions = []
    for i, tid in enumerate(ordering):
        tn_hole = tnAB.copy(virtual=True)
        ti = tn_hole._pop_tensor(tid)
        tid_prev = ordering[(i - 1) % len(ordering)]
        if tid_prev == tid:
            canon_pairs = []
        else:
            ptids = get_path_between_tids(tn_fit, tid_prev, tid).tids
            canon_pairs = list(zip(ptids[:-1], ptids[1:]))
        env_contractions.append((tid, tn_hole, ti, canon_pairs))

    tn_fit._canonize_around_tids([ordering[0]])
    old_d = None
    for step in range(steps):
        for tid, tn_hole, ti, canon_pairs in env_contractions:
            if istree:
                for tidi, tidj in canon_pairs:
                    tn_fit._canonize_between_tids(tidi, tidj)
            else:
                tn_fit._canonize_around_tids([tid])
            ti_new = tn_hole.contract(..., output_inds=ti.inds,
                                      preserve_tensor=True, **contract_opts)
            ti.modify(data=ti_new.data.conj())
        # canonical form: <A|A> = |t|^2 = <A|B>
        xAA = float(ti.norm()) ** 2
        d = 2 * abs(xBB - xAA) ** 0.5 / (xBB**0.5 + xAA**0.5)
        if progbar:
            print(f"tree fit step {step}: distance {d}")
        if old_d is not None and abs(old_d - d) < tol:
            break
        old_d = d
    return tn_fit.conj_()


def tensor_network_fit_autodiff(tn, tn_target, steps=1000, tol=1e-9,
                                init="current", autodiff_backend="torch",
                                inplace=False, progbar=False, **kwargs):
    """Fit by minimising ``|A - B|^2`` with :class:`TNOptimizer`
    (reference ``tensor_network_fit_autodiff`` fitting.py:156)."""
    from .optimize import TNOptimizer

    tn_fit = tn if inplace else tn.copy()
    tn_target = _as_tn(tn_target)
    xBB = _overlap(tn_target, tn_target)

    def loss(tn_v, tn_target=tn_target):
        xAA = (tn_v | tn_v.conj(mangle_inner=True)).contract(...)
        xAB = (tn_v.conj(mangle_inner=True) | tn_target).contract(...)
        return xAA.real - 2 * xAB.real + abs(xBB)

    opt = TNOptimizer(tn_fit, loss, progbar=progbar, **kwargs)
    out = opt.optimize(steps, tol=tol)
    if inplace:
        tn.set_params(out.get_params())
        return tn
    return out
