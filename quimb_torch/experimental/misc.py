"""Miscellaneous experimental sketches (reference
``quimb/experimental/misc/``): the PEPS-DMRG virtual operators
(peps_dmrg.py:4,46,109,146), a translationally invariant CTMRG
partition-function contractor (renormalization.py:10), and product
expectation helpers.

Port of quimb_tpu's ``experimental/misc.py``. All array work stays on the
tensors' device; a CTMRG growth step is three einsums and one ``eigh``
(with ``strip_exponent`` it also reads two norms to the host, as
quimb_tpu's does).
"""

import math

import numpy as np
import torch

from ..core import kron
from ..ops.backend import resolve_device, to_device
from ..tensor.core import rand_uuid


# --------------------------------------------------------------------------
# PEPS-DMRG style virtual operators (reference peps_dmrg.py)
# --------------------------------------------------------------------------


def virtual_bond_operator(tn, ind, operators=None, **contract_opts):
    """The environment operator of bond ``ind``: cut the bond open in
    both ket and bra layers and contract everything else, giving the
    matrix mapping the cut ket bond to the cut bra bond (reference
    ``virtual_bond_operator`` peps_dmrg.py:4). With ``operators``
    given ({site: G}), they are applied to the ket layer first — so
    eigenvectors of the result give DMRG-style optimal bond updates.
    """
    operators = {} if operators is None else dict(operators)

    ket = tn.copy()
    ixkl, ixkr, ixbl, ixbr = (rand_uuid() for _ in range(4))
    ket.cut_bond(ind, ixkl, ixkr)
    bra = ket.H
    bra.reindex_({ixkl: ixbl, ixkr: ixbr})
    bra.mangle_inner_()

    for where, G in operators.items():
        ket.gate_(G, where)

    overlap = ket | bra
    out = overlap.contract(
        ..., output_inds=(ixbl, ixbr, ixkl, ixkr),
        preserve_tensor=True, **contract_opts,
    )
    return out.to_dense((ixbl, ixbr), (ixkl, ixkr))


def virtual_site_operator(tn, site, operators=None, **contract_opts):
    """The environment operator of site ``site``: remove the site
    tensor from ket and bra and contract the rest, giving the matrix
    on the site's virtual bonds (reference ``virtual_site_operator``
    peps_dmrg.py:46); the physical leg contributes an identity (or
    the operator assigned to this site) as a kron factor."""
    operators = {} if operators is None else dict(operators)

    ket = tn.copy()
    (tid,) = ket._get_tids_from_tags(ket.site_tag(site), "all")
    t = ket.pop_tensor(tid)

    phys_ind = tn.site_ind(site)
    k_ix = tuple(ix for ix in t.inds if ix != phys_ind)
    reindex = {ix: rand_uuid() for ix in k_ix}
    b_ix = tuple(reindex[ix] for ix in k_ix)
    bra = ket.conj()
    bra.reindex_(reindex)
    bra.mangle_inner_()

    if phys_ind not in t.inds:
        dangling = None
    elif site in operators:
        dangling = to_device(operators.pop(site), device=t.data.device)
    else:
        d = t.ind_size(phys_ind)
        dangling = torch.eye(d, dtype=t.data.dtype, device=t.data.device)

    for where, G in operators.items():
        ket.gate_(G, where)

    overlap = ket | bra
    X = overlap.contract(
        ..., output_inds=(*b_ix, *k_ix), preserve_tensor=True,
        **contract_opts,
    ).to_dense(b_ix, k_ix)

    if dangling is not None:
        X = kron(X, dangling, device=X.device)
    return X


def _apply_gates_at_inds(k, Gs, inds):
    """Contract each single-site gate ``G`` into the tensor holding
    its physical index."""
    from ..tensor.gating import tensor_network_gate_inds

    for G, ind in zip(Gs, inds):
        t = k.tensor_map[next(iter(k.ind_map[ind]))]
        tensor_network_gate_inds(
            k, to_device(G, device=t.data.device), (ind,), contract=True,
            inplace=True,
        )
    return k


def product_expectation_exact(tn, Gs, where, normalized=True,
                              site_inds=None, **contract_opts):
    """<psi| prod_i G_i |psi> with each single-site ``G_i`` applied at
    ``where[i]`` — by full contraction (reference
    ``product_expectation_exact`` peps_dmrg.py:109). ``site_inds``
    overrides the physical-index lookup (used by the cluster variant,
    whose patch is a plain TensorNetwork)."""
    if site_inds is None:
        site_inds = [tn.site_ind(s) for s in where]
    k = tn.copy()
    b = k.H
    b.mangle_inner_()
    _apply_gates_at_inds(k, Gs, site_inds)
    expec = (b | k).contract(..., output_inds=(), **contract_opts)
    if normalized:
        k = tn.copy()
        nfact = (b | k).contract(..., output_inds=(), **contract_opts)
        expec = expec / nfact
    return expec


def product_expectation_cluster(tn, Gs, where, normalized=True,
                                max_distance=0, gauges=None,
                                **contract_opts):
    """Cluster approximation of :func:`product_expectation_exact`:
    contract only a local neighbourhood of the acted sites, with the
    cut environment approximated by simple-update gauges (reference
    ``product_expectation_cluster`` peps_dmrg.py:146)."""
    site_inds = [tn.site_ind(s) for s in where]
    tags = tuple(tn.site_tag(s) for s in where)
    k = tn.select_local(tags, which="any",
                        max_distance=max_distance, virtual=False)
    if gauges is not None:
        k.gauge_simple_insert(gauges)
    return product_expectation_exact(
        k, Gs, where, normalized=normalized, site_inds=site_inds,
        **contract_opts,
    )


# --------------------------------------------------------------------------
# translationally invariant CTMRG (reference renormalization.py:10)
# --------------------------------------------------------------------------


def ctmrg_partition_function(T, A, C, L, max_bond,
                             strip_exponent=False, device=None):
    """Contract the L x L translationally-invariant network with bulk
    tensor ``T`` (d,d,d,d), edge tensor ``A`` (d,d,chi_t) and corner
    ``C`` (d,d) by corner-transfer-matrix growth (reference ``CTMRG``
    renormalization.py:10, symmetric case).

    Each growth step is three einsums + one eigh of the (chi*d)²
    corner — the isometry keeping the ``max_bond`` largest-magnitude
    eigenvalues renormalizes both the corner and the edge.

    Returns ``Z`` (and the log10 ``exponent`` if
    ``strip_exponent=True``, such that the true value is
    ``Z * 10**exponent``). Host arrays go to ``device`` (the GPU unless
    given); tensors stay where they are.
    """
    if (L < 4) or (L % 2 != 0):
        raise ValueError("L must be an even integer >= 4.")
    if not isinstance(T, torch.Tensor):
        device = resolve_device(device)
    T, A, C = (x if isinstance(x, torch.Tensor) else to_device(x, device)
               for x in (T, A, C))
    d = T.shape[0]
    # cumulative log10 scale factors of the working (normalized) A and
    # C relative to their true values: A_true = A * 10**la etc. The
    # corner rebuild C' = eigvals(corner_block(C, A)) is linear in C
    # and quadratic in A, so lc <- lc + 2 la at each step; the side
    # growth is linear in A, leaving la unchanged. (The reference
    # leaves this accounting as a TODO, renormalization.py:170.)
    la = lc = 0.0

    def corner_block(C, A):
        # M[ad, td, br, tr] = C[ca,cb] A[ca,ad,at] A[cb,br,bt]
        #                     T[at,td,tr,bt]
        X = torch.einsum("ab,ade->bde", C, A)          # b, ad, at
        X = torch.einsum("bde,bfg->defg", X, A)        # ad, at, br, bt
        X = torch.einsum("defg,ehig->dhfi", X, T)      # ad, td, br, tr
        return X

    for _ in range(2, L - 2, 2):
        chi = A.shape[0]
        X = corner_block(C, A)                       # (chi,d,chi,d)
        CTM = X.reshape(chi * d, chi * d)
        CTM = (CTM + CTM.conj().T) / 2
        s, U = torch.linalg.eigh(CTM)
        order = torch.argsort(-torch.abs(s), stable=True)
        k = min(max_bond, s.shape[0])
        keep = order[:k]
        s = s[keep]
        U = U[:, keep]                               # (chi*d, k)
        C = torch.diag(s)
        lc = lc + 2 * la
        U3 = U.reshape(chi, d, k)
        # side growth: A'[u, dn, r] =
        #   A[au, ad, at] T[at, td, r, tu] U[au, tu, u] U*[ad, td, dn]
        Y = torch.einsum("ade,ethu->adthu", A, T)      # au,ad,td,r,tu
        Y = torch.einsum("adthu,auv->dthv", Y, U3)     # ad,td,r,u
        A = torch.einsum("dthv,dtw->vwh", Y, U3.conj())
        if strip_exponent:
            an = float(torch.linalg.norm(A))
            cn = float(torch.linalg.norm(C))
            if an > 0:
                A = A / an
                la += np.log10(an)
            if cn > 0:
                C = C / cn
                lc += np.log10(cn)

    chi = A.shape[0]
    X = corner_block(C, A)
    CTM = X.reshape(chi * d, chi * d)
    Z = torch.trace(CTM @ CTM @ CTM @ CTM)
    if strip_exponent:
        # Z uses 4 corner blocks, each with one C and two A's
        return Z, 4 * lc + 8 * la
    return Z


def classical_ising_T_A_C(beta, j=1.0, h=0.0, device=None):
    """Bulk/edge/corner tensors of the square-lattice classical Ising
    partition function at inverse temperature ``beta`` (to feed
    :func:`ctmrg_partition_function`; reference builds these via
    ``TN2D_classical_ising_partition_function`` arrays), float64 on
    ``device`` (the GPU unless given)."""
    device = resolve_device(device)
    q = torch.tensor([
        [math.exp(beta * j), math.exp(-beta * j)],
        [math.exp(-beta * j), math.exp(beta * j)],
    ], dtype=torch.float64, device=device)
    # symmetric square root of the bond weight
    s, u = torch.linalg.eigh(q)
    hq = (u * torch.sqrt(torch.clamp(s, min=0.0))) @ u.T
    site = torch.tensor([math.exp(beta * h), math.exp(-beta * h)],
                        dtype=torch.float64, device=device)
    T = torch.einsum("s,si,sj,sk,sl->ijkl", site, hq, hq, hq, hq)
    A = torch.einsum("s,si,sj,sk->ijk", site, hq, hq, hq)
    C = torch.einsum("s,si,sj->ij", site, hq, hq)
    return T, A, C


__all__ = [
    "classical_ising_T_A_C",
    "ctmrg_partition_function",
    "product_expectation_cluster",
    "product_expectation_exact",
    "virtual_bond_operator",
    "virtual_site_operator",
]
