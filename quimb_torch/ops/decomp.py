"""Truncated splits and sign-fixed QR / LQ, the splits of the DMRG engines.

Port of the matching parts of ``quimb_tpu/ops/decomp.py``: the masked
truncated SVD, its gram-matrix ``eigh`` variant (``svd:eig``), the
randomized-subspace variants (``svd:sub``, ``svd:sub0``) and QR / LQ with
fixed signs. The TPU's square-padding shims, its re-orthogonalising QR
and its triangular-matmul cumsum are not needed: cuSOLVER and LAPACK take
rectangular factorizations as they are.
"""

import torch

# -- mode maps (the reference's numeric codes) -------------------------------

CUTOFF_MODE_MAP = {
    "abs": 1, 1: 1,
    "rel": 2, 2: 2,
    "sum2": 3, 3: 3,
    "rsum2": 4, 4: 4,
    "sum1": 5, 5: 5,
    "rsum1": 6, 6: 6,
}

_ABSORB_ALIASES = {
    None: None, "U,s,VH": None,
    "both": "both", "Usq,sqVH": "both", 0: "both",
    "left": "left", "Us,VH": "left", -1: "left",
    "right": "right", "U,sVH": "right", 1: "right",
    "lorthog": "lorthog", "U": "lorthog",
    "rorthog": "rorthog", "VH": "rorthog",
    "lfactor": "lfactor", "Us": "lfactor",
    "rfactor": "rfactor", "sVH": "rfactor",
    "lsqrt": "lsqrt", "Usq": "lsqrt",
    "rsqrt": "rsqrt", "sqVH": "rsqrt",
    "s": "s", "svals": "s",
}


def parse_absorb(absorb):
    try:
        return _ABSORB_ALIASES[absorb]
    except KeyError:
        raise ValueError(f"Invalid absorb mode: {absorb!r}")


# -- small helpers -----------------------------------------------------------


def dag(x):
    """Hermitian conjugate of (a batch of) matrices."""
    return torch.conj(torch.swapaxes(x, -2, -1))


def rdmul(x, d):
    """Multiply the columns of ``x`` by the vector ``d`` (x @ diag(d))."""
    return x * d[..., None, :].to(x.dtype)


def ldmul(d, x):
    """Multiply the rows of ``x`` by the vector ``d`` (diag(d) @ x)."""
    return x * d[..., :, None].to(x.dtype)


def sgn(x):
    """Phase-like sign: x / |x|, with sgn(0) = 1."""
    ones = torch.ones_like(x)
    x0 = torch.where(x == 0, ones, x)
    return torch.where(x == 0, ones, x0 / torch.abs(x0))


def _random_start(shape, dtype, device, seed):
    """Standard normal draws from a generator of ``device`` seeded with
    ``seed``: the same numbers at every call with the same arguments."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


# -- factorizations ----------------------------------------------------------


#: complex SVD batches on CUDA that ``gesvdj`` failed to converge on and
#: ``gesvd`` redid on the card, by the dtype of the input
SVD_REDOS = {torch.complex128: 0, torch.complex64: 0}


def _svd_call(x, driver):
    return torch.linalg.svd(x, full_matrices=False, driver=driver)


def _svd_driver(x):
    """cuSOLVER driver of every SVD of ``x``'s device and dtype, LAPACK's
    default on the CPU. Measured on an H100:

    - real: ``gesvd``. The Jacobi driver ``gesvdj`` returned float32
      factors of the 512 x 512 DMRG splits with ||U^T U - I|| ~ 1e-3, and
      the sweep energies drifted up by 1e-3 per sweep; ``gesvd`` keeps it
      at ~6e-6.
    - complex: ``gesvdj`` in complex128, checked (:func:`_checked_gesvdj`).
      On TEBD's (32, 128, 128) batches it keeps ||U^H U - I||_2 at 1.6e-14
      and takes 39-44 ms, against 285-309 ms for ``gesvd``, whose
      per-matrix loop is bound by its kernel launches. A complex64 input
      is taken to complex128 first: complex64's own ``gesvdj`` failed to
      converge on a theta of the L=64 quench, and its ``gesvd`` took
      253-328 ms a parity sweep.
    """
    if not x.is_cuda:
        return None
    return "gesvdj" if x.is_complex() else "gesvd"


def _checked_gesvdj(x):
    """``gesvdj`` of ``x`` in complex128. Where it fails to converge, the
    same batch is redone with ``gesvd`` on the card and counted in
    :data:`SVD_REDOS`; a second failure raises."""
    try:
        return _svd_call(x.to(torch.complex128), "gesvdj")
    except torch.linalg.LinAlgError:
        SVD_REDOS[x.dtype] += 1
        return _svd_call(x.to(torch.complex128), "gesvd")


def safe_svd(x):
    """Thin SVD of (a batch of) matrices, real or complex, by the driver
    of :func:`_svd_driver`. quimb_tpu pads rectangular inputs to square
    ones on the TPU; cuSOLVER and LAPACK take them as they are."""
    driver = _svd_driver(x)
    if driver != "gesvdj":
        return _svd_call(x, driver)
    U, s, VH = _checked_gesvdj(x)
    return U.to(x.dtype), s.to(x.real.dtype), VH.to(x.dtype)


def safe_qr(x):
    """Reduced QR of (a batch of) matrices. quimb_tpu pads rectangular
    inputs to square ones and orthogonalises twice on the TPU; LAPACK and
    cuSOLVER need neither."""
    return torch.linalg.qr(x)


def safe_eigh(x):
    """Hermitian eigendecomposition of (a batch of) matrices, eigenvalues
    ascending."""
    return torch.linalg.eigh(x)


# -- QR / LQ -----------------------------------------------------------------


def qr_stabilized(x):
    """QR with R's diagonal made real-positive. Returns ``(Q, None, R)``."""
    Q, R = torch.linalg.qr(x)
    s = sgn(torch.diagonal(R, dim1=-2, dim2=-1))
    return Q * s[..., None, :], None, R * torch.conj(s)[..., :, None]


def lq_stabilized(x):
    """LQ decomposition ``x = L @ Q`` with ``Q`` row-isometric and ``L``'s
    diagonal real-positive. Returns ``(L, None, Q)``."""
    Qt, Rt = torch.linalg.qr(torch.swapaxes(x, -2, -1))
    s = sgn(torch.diagonal(Rt, dim1=-2, dim2=-1))
    Qt = Qt * s[..., None, :]
    Rt = Rt * torch.conj(s)[..., :, None]
    return torch.swapaxes(Rt, -2, -1), None, torch.swapaxes(Qt, -2, -1)


# -- masked truncated SVD ----------------------------------------------------


def svd_truncated_masked(
    x, max_bond, cutoff=0.0, cutoff_mode=4, renorm=0, absorb="both"
):
    """Truncated SVD whose output shapes depend only on ``max_bond``.

    Singular values failing the ``cutoff`` criterion are zero-masked
    rather than dropped. Returns ``(U, s, VH, rank)`` where the factors
    have bond size ``k = min(max_bond, min(m, n))`` and ``rank <= k``
    counts the surviving values.
    """
    U, s, VH = safe_svd(x)
    return _truncate_mask_absorb(
        U, s, VH, max_bond=max_bond, cutoff=cutoff,
        cutoff_mode=cutoff_mode, renorm=renorm, absorb=absorb,
    )


def _truncate_mask_absorb(U, s, VH, max_bond, cutoff, cutoff_mode,
                          renorm, absorb):
    if max_bond is None or max_bond <= 0:
        k = s.shape[-1]
    else:
        k = min(max_bond, s.shape[-1])
    U = U[..., :, :k]
    VH = VH[..., :k, :]
    skept = s[..., :k]

    sp = s * s if cutoff_mode in (3, 4) else s
    # tail sums, tail[i] = sum_{j >= i} sp[j]: value i is kept while the
    # weight from it on is above the cutoff. quimb_tpu tests the exclusive
    # prefix sums against tot - cutoff instead, the same test in exact
    # arithmetic; but in float32 those sums reach tot early and drop the
    # tail below float32's resolution of tot at any cutoff. A tail sum
    # holds its small values, so every nonzero value passes cutoff 0.
    tail = torch.flip(torch.cumsum(torch.flip(sp, (-1,)), dim=-1), (-1,))
    tot = tail[..., 0:1]

    idx = torch.arange(k, device=s.device)
    if cutoff_mode == 1:
        mask = skept > cutoff
    elif cutoff_mode == 2:
        mask = skept > cutoff * skept[..., 0:1]
    elif cutoff_mode in (4, 6):
        mask = tail[..., :k] > cutoff * tot
    else:
        mask = tail[..., :k] > cutoff
    # always keep at least one value
    mask = torch.logical_or(mask, idx == 0)
    rank = torch.sum(mask, dim=-1)

    s_out = torch.where(mask, skept, torch.zeros_like(skept))
    if renorm:
        pow = 2 if cutoff_mode in (3, 4) else 1
        kept = torch.where(mask, sp[..., :k], torch.zeros_like(skept))
        f = (tot[..., 0] / torch.sum(kept, dim=-1)) ** (1.0 / pow)
        s_out = s_out * f[..., None]

    mU = mask[..., None, :].to(U.dtype)
    mV = mask[..., :, None].to(VH.dtype)
    if absorb == "both":
        sq = torch.sqrt(s_out)
        return rdmul(U, sq) * mU, s_out, ldmul(sq, VH) * mV, rank
    elif absorb == "left":
        return rdmul(U, s_out) * mU, s_out, VH * mV, rank
    elif absorb == "right":
        return U * mU, s_out, ldmul(s_out, VH) * mV, rank
    else:
        return U * mU, s_out, VH * mV, rank


# -- gram-matrix and randomized-subspace splits ------------------------------


def _gram_eigh(G):
    """``eigh`` of the gram matrix ``G`` as singular values: (s, s_safe,
    W), the values descending, the same with those below eps set to 1
    (safe to divide by), and their vectors."""
    el, W = safe_eigh(G)
    el, W = torch.flip(el, (-1,)), torch.flip(W, (-1,))
    s = torch.sqrt(torch.clamp(el, min=0.0))
    eps = torch.finfo(s.dtype).eps
    return s, torch.where(s > eps, s, torch.ones_like(s)), W


def _eig_factors(x, absorb):
    """Thin SVD factors of ``x`` from a hermitian ``eigh`` of its gram
    matrix, singular values descending. The side is chosen so that the
    factor that must stay isometric comes from the ``eigh`` itself: the
    ``x† x`` side (V) for ``absorb="left"``, the ``x x†`` side (U)
    otherwise. The other factor is recovered by division, and its noise
    below about sqrt(eps) s_0 is what the absorbed ``s`` rescales."""
    if absorb == "left":
        s, s_safe, V = _gram_eigh(dag(x) @ x)
        return (x @ V) / s_safe[..., None, :], s, dag(V)
    s, s_safe, U = _gram_eigh(x @ dag(x))
    return U, s, (dag(U) @ x) / s_safe[..., :, None]


def svd_truncated_masked_eig(
    x, max_bond, cutoff=0.0, cutoff_mode=4, renorm=0, absorb="both"
):
    """:func:`svd_truncated_masked` through a hermitian ``eigh`` of the
    gram matrix (``svd:eig``), with the same masks and absorb modes. The
    gram matrix squares the condition number: singular values below
    about sqrt(eps) s_0 come out as noise, but the isometric factor stays
    exactly isometric (:func:`_eig_factors`)."""
    U, s, VH = _eig_factors(x, absorb)
    # the gram side can exceed the rank side: cap at min(m, n) so that
    # the shapes match the plain SVD's
    kmax = min(x.shape[-2], x.shape[-1])
    return _truncate_mask_absorb(
        U[..., :, :kmax], s[..., :kmax], VH[..., :kmax, :],
        max_bond=max_bond, cutoff=cutoff, cutoff_mode=cutoff_mode,
        renorm=renorm, absorb=absorb,
    )


def _subspace_basis(G, k, iters, dtype, omega=None):
    """Orthonormal basis (m, k) of the dominant ``k``-dimensional
    eigenspace of the PSD matrix ``G`` (m, m) by subspace iteration: each
    round is one (m, m, k) product and one tall QR. ``omega`` (m, k) is
    the start; without it, standard normal draws from a generator of
    ``G``'s device seeded 0, so every call is repeatable. (quimb_tpu
    draws from ``jax.random.PRNGKey(0)``, which torch cannot reproduce;
    pass its draw as ``omega`` to follow it.)"""
    m = G.shape[-1]
    if omega is None:
        omega = _random_start((*G.shape[:-2], m, k), G.real.dtype,
                              G.device, seed=0)
    V = omega.to(dtype)
    for _ in range(max(iters, 1)):
        Q, _ = safe_qr(G @ V)
        V = Q[..., :, :k]
    return V


def _bond_sizes(x, max_bond, oversample):
    """(k, kp, kmax): the kept rank, the iterated rank with its
    oversampling, and min(m, n)."""
    kmax = min(x.shape[-2], x.shape[-1])
    k = min(max_bond, kmax) if (max_bond and max_bond > 0) else kmax
    return k, min(k + max(oversample, 0), kmax), kmax


def svd_truncated_masked_subspace(
    x, max_bond, cutoff=0.0, cutoff_mode=4, renorm=0, absorb="both",
    iters=2, oversample=8, omega=None,
):
    """Truncated SVD by randomized subspace iteration plus a
    Rayleigh-Ritz step of size ``max_bond + oversample`` (``svd:sub``),
    with the masks and absorb modes of :func:`svd_truncated_masked_eig`.
    ``omega`` is the start of :func:`_subspace_basis`: (n, kp) for
    ``absorb="left"``, (m, kp) otherwise. Where ``max_bond`` cuts
    nothing, this is :func:`svd_truncated_masked_eig`."""
    k, kp, kmax = _bond_sizes(x, max_bond, oversample)
    if k >= kmax:
        return svd_truncated_masked_eig(
            x, max_bond=max_bond, cutoff=cutoff, cutoff_mode=cutoff_mode,
            renorm=renorm, absorb=absorb,
        )
    if absorb == "left":
        # the dominant row space: VH = dag(basis) stays isometric
        Vr = _subspace_basis(dag(x) @ x, kp, iters, x.dtype, omega)
        B = x @ Vr                                   # (m, kp)
        s, s_safe, W = _gram_eigh(dag(B) @ B)        # (kp, kp)
        U, VH = (B @ W) / s_safe[..., None, :], dag(Vr @ W)
    else:
        # the dominant column space: U = basis stays isometric
        V = _subspace_basis(x @ dag(x), kp, iters, x.dtype, omega)
        B = dag(V) @ x                               # (kp, n)
        s, s_safe, W = _gram_eigh(B @ dag(B))        # (kp, kp)
        U, VH = V @ W, (dag(W) @ B) / s_safe[..., :, None]
    return _truncate_mask_absorb(
        U, s, VH, max_bond=k, cutoff=cutoff, cutoff_mode=cutoff_mode,
        renorm=renorm, absorb=absorb,
    )


def split_truncated_subspace(x, max_bond, absorb="right", iters=2,
                             oversample=8, omega=None):
    """Rank-``max_bond`` split ``x ~= U @ VH`` with no cutoff mask
    (``svd:sub0``): the isometric factor is an orthonormal basis of the
    dominant subspace, from an oversampled subspace iteration and, when
    ``oversample > 0``, a Rayleigh-Ritz rotation of size
    ``max_bond + oversample`` that drops the padding directions. The
    bond basis is pure gauge, so no singular value is needed. Returns
    ``(U, None, VH, rank)`` like the masked drivers; ``omega`` as in
    :func:`svd_truncated_masked_subspace`. ``x`` may carry leading batch
    dimensions, which one ``omega`` serves."""
    k, kp, kmax = _bond_sizes(x, max_bond, oversample)
    if k >= kmax:
        return svd_truncated_masked_eig(x, max_bond=k, cutoff=0.0,
                                        absorb=absorb)
    if absorb == "left":
        Vr = _subspace_basis(dag(x) @ x, kp, iters, x.dtype, omega)
        if kp > k:
            B = x @ Vr                               # (m, kp)
            _, W = safe_eigh(dag(B) @ B)             # (kp, kp)
            Vr = Vr @ torch.flip(W, (-1,))[..., :, :k]
        U, VH = x @ Vr, dag(Vr)
    else:
        V = _subspace_basis(x @ dag(x), kp, iters, x.dtype, omega)
        if kp > k:
            B = dag(V) @ x                           # (kp, n)
            _, W = safe_eigh(B @ dag(B))             # (kp, kp)
            V = V @ torch.flip(W, (-1,))[..., :, :k]
        U, VH = V, dag(V) @ x
    return U, None, VH, torch.full((), k, dtype=torch.int64,
                                   device=x.device)
