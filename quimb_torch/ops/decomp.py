"""Truncated splits and sign-fixed QR / LQ: the splits of the DMRG and
TEBD engines, and ``array_split`` with its registered drivers, the split
engine of the tensor-network layer.

Port of ``quimb_tpu/ops/decomp.py``: the masked truncated SVD, its
gram-matrix ``eigh`` variant (``svd:eig``), the randomized-subspace
variants (``svd:sub``, ``svd:sub0``), QR / LQ with fixed signs,
``array_split`` with its method, absorb and cutoff-mode maps and its
dynamic-rank trim (one device-to-host read of the kept rank per split),
the drivers (``svd``, ``svd:eig``, ``svd:rand``, ``qr``, ``qr:cholesky``,
``eigh``, ``cholesky``, ``polar_right`` / ``polar_left``, ``lu``),
``isometrize`` and the oblique projectors of the bond compressions. The
TPU's square-padding shims, its re-orthogonalising QR and its
triangular-matmul cumsum are not needed: cuSOLVER and LAPACK take
rectangular factorizations as they are. A numpy operand is split on the
host, by LAPACK, only under ``contract_backend("numpy")``, as in
quimb_tpu.
"""

import numpy as np
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


# power used when ``renorm=True`` for each cutoff mode
RENORM_LOOKUP = {3: 2, 4: 2, 5: 1, 6: 1}


def parse_absorb(absorb):
    try:
        return _ABSORB_ALIASES[absorb]
    except KeyError:
        raise ValueError(f"Invalid absorb mode: {absorb!r}")


def parse_cutoff_mode(cutoff_mode):
    try:
        return CUTOFF_MODE_MAP[cutoff_mode]
    except KeyError:
        raise ValueError(f"Invalid cutoff mode: {cutoff_mode!r}")


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
SVD_REDOS = {torch.complex128: 0, torch.complex64: 0, torch.float64: 0,
             torch.float32: 0}


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


def _checked_gesvdj(x, dtype=torch.complex128):
    """``gesvdj`` of ``x`` in ``dtype``. Where it fails to converge, the
    same batch is redone with ``gesvd`` on the card and counted in
    :data:`SVD_REDOS` under ``x``'s dtype; a second failure raises."""
    try:
        return _svd_call(x.to(dtype), "gesvdj")
    except torch.linalg.LinAlgError:
        SVD_REDOS[x.dtype] += 1
        return _svd_call(x.to(dtype), "gesvd")


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


def _np_sgn(x):
    x0 = np.where(x == 0, 1.0, x)
    return np.where(x == 0, np.ones_like(x), x0 / np.abs(x0))


def qr_stabilized(x):
    """QR with R's diagonal made real-positive. Returns ``(Q, None, R)``."""
    if isinstance(x, np.ndarray):
        Q, R = np.linalg.qr(x)
        sg = _np_sgn(np.diagonal(R, axis1=-2, axis2=-1))
        return Q * sg[..., None, :], None, R * np.conj(sg)[..., :, None]
    Q, R = torch.linalg.qr(x)
    s = sgn(torch.diagonal(R, dim1=-2, dim2=-1))
    return Q * s[..., None, :], None, R * torch.conj(s)[..., :, None]


def lq_stabilized(x):
    """LQ decomposition ``x = L @ Q`` with ``Q`` row-isometric and ``L``'s
    diagonal real-positive. Returns ``(L, None, Q)``."""
    if isinstance(x, np.ndarray):
        Qt, Rt = np.linalg.qr(np.swapaxes(x, -2, -1))
        sg = _np_sgn(np.diagonal(Rt, axis1=-2, axis2=-1))
        Qt = Qt * sg[..., None, :]
        Rt = Rt * np.conj(sg)[..., :, None]
        return np.swapaxes(Rt, -2, -1), None, np.swapaxes(Qt, -2, -1)
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


# -- array_split: the dynamic-rank split engine ------------------------------


def rddiv(x, d):
    return x / d[..., None, :].to(x.dtype)


def lddiv(d, x):
    return x / d[..., :, None].to(x.dtype)


def _nchi(sabs, cutoff, cutoff_mode):
    """Number of singular values to keep under ``cutoff``: the
    cumulative-spectrum rule of quimb_tpu's ``_nchi_kernel``. ``sabs``
    may be batched; the max over the batch is taken. Numpy or torch."""
    xp = np if isinstance(sabs, np.ndarray) else torch
    if cutoff_mode == 1:  # abs
        n_chi = (sabs > cutoff).sum(-1)
    elif cutoff_mode == 2:  # rel
        n_chi = (sabs > cutoff * sabs[..., 0:1]).sum(-1)
    else:
        sp = sabs * sabs if cutoff_mode in (3, 4) else sabs
        csp = xp.cumsum(sp, -1)
        tot = csp[..., -1:]
        if cutoff_mode in (4, 6):
            above = csp < tot * (1 - cutoff)
        else:
            above = csp < tot - cutoff
        n_chi = above.sum(-1) + 1
    return n_chi.max()


def _resolve_nchi(sabs, cutoff, cutoff_mode, max_bond, renorm):
    """The number of singular values to keep, as a host int: one
    device-to-host read when a cutoff or a renormalisation asks for it."""
    d = sabs.shape[-1]
    if (cutoff is not None and cutoff > 0.0) or (renorm and renorm > 0):
        n_chi = max(int(_nchi(sabs, cutoff if cutoff else 0.0,
                              cutoff_mode)), 1)
        if max_bond and max_bond > 0:
            n_chi = min(n_chi, max_bond)
    elif max_bond and max_bond > 0:
        n_chi = min(max_bond, d)
    else:
        n_chi = d
    return n_chi


def _trim_and_renorm(U, s, VH, cutoff=-1.0, cutoff_mode=4, max_bond=-1,
                     absorb="both", renorm=0, use_abs=False, info=None):
    """Truncate, renormalise and absorb an SVD-like result (numpy or
    torch). The kept rank is a host int, so the factors are sliced to
    it."""
    cutoff_mode = parse_cutoff_mode(cutoff_mode)
    absorb = parse_absorb(absorb)
    xp = np if isinstance(s, np.ndarray) else torch
    sabs = xp.abs(s) if use_abs else s
    d = s.shape[-1]
    n_chi = _resolve_nchi(sabs, cutoff, cutoff_mode, max_bond, renorm)
    if n_chi < d:
        if info is not None and "error" in info:
            info["error"] = float(
                (sabs[..., n_chi:] ** 2).sum(-1).max() ** 0.5)
        if renorm:
            pw = (RENORM_LOOKUP.get(cutoff_mode, 2) if renorm is True
                  else int(renorm))
            csp = xp.cumsum(sabs**pw, -1)
            f = (csp[..., -1] / csp[..., n_chi - 1]) ** (1.0 / pw)
            s = s[..., :n_chi] * f[..., None]
        else:
            s = s[..., :n_chi]
        U = U[..., :, :n_chi]
        VH = VH[..., :n_chi, :]
    elif info is not None and "error" in info:
        info["error"] = 0.0
    return _do_absorb(U, s, VH, absorb)


def _do_absorb(U, s, VH, absorb):
    """Absorb singular values per mode; unrequested factors are ``None``
    (numpy or torch)."""
    if absorb is None:
        return U, s, VH
    sqrt = np.sqrt if isinstance(s, np.ndarray) else torch.sqrt

    def r(x, d):
        return x * d[..., None, :].astype(x.dtype) if isinstance(
            x, np.ndarray) else rdmul(x, d)

    def l(d, x):
        return x * d[..., :, None].astype(x.dtype) if isinstance(
            x, np.ndarray) else ldmul(d, x)

    if absorb == "both":
        sq = sqrt(s)
        return r(U, sq), None, l(sq, VH)
    if absorb == "right":
        return U, None, l(s, VH)
    if absorb == "left":
        return r(U, s), None, VH
    if absorb == "rfactor":
        return None, None, l(s, VH)
    if absorb == "lfactor":
        return r(U, s), None, None
    if absorb == "lorthog":
        return U, None, None
    if absorb == "rorthog":
        return None, None, VH
    if absorb == "lsqrt":
        return r(U, sqrt(s)), None, None
    if absorb == "rsqrt":
        return None, None, l(sqrt(s), VH)
    if absorb == "s":
        return None, s, None
    raise ValueError(f"Invalid absorb mode: {absorb}")


_SPLIT_DRIVERS = {}
_FULL_SPLIT_OPTS = frozenset(
    ("cutoff", "cutoff_mode", "max_bond", "absorb", "renorm", "info")
)
_DRIVER_OPTS = {}


def register_split_driver(name, accepts=_FULL_SPLIT_OPTS):
    """Register a function as a split driver for ``array_split``."""

    def _register(fn):
        _SPLIT_DRIVERS[name] = fn
        _DRIVER_OPTS[name] = frozenset(accepts)
        return fn

    return _register


def array_split(x, method="svd", absorb="auto", max_bond=None, cutoff=1e-10,
                cutoff_mode="rsum2", renorm=None, info=None, **kwargs):
    """Split a 2D (batch of) array(s) into left/right factors, dispatching
    on ``method``. Returns ``(left, s, right)`` with ``None`` placeholders
    depending on ``absorb``. A tensor is split on its own device; a numpy
    array on the host under ``contract_backend("numpy")`` (methods
    ``svd`` and ``qr``), else on the default device."""
    if method == "auto":
        truncating = (max_bond is not None and max_bond > 0) or (
            cutoff is not None and cutoff > 0
        )
        if absorb in ("auto", "both", None) or truncating:
            method = "svd"
        elif absorb == "right":
            method = "qr"
        elif absorb == "left":
            method = "lq"
        else:
            method = "svd"

    if method == "lq":
        method = "qr"
        if absorb in ("auto", None):
            absorb = "left"

    if absorb == "auto":
        absorb = {"qr": "right", "qr:cholesky": "right",
                  "polar_right": "right", "polar_left": "left",
                  "cholesky": "both", "lu": "both"}.get(method, "both")

    fn = _SPLIT_DRIVERS[method]
    accepts = _DRIVER_OPTS[method]

    opts = dict(kwargs)
    if "absorb" in accepts:
        opts["absorb"] = parse_absorb(absorb)
    if "max_bond" in accepts:
        opts["max_bond"] = -1 if max_bond is None else int(max_bond)
    if "cutoff" in accepts:
        opts["cutoff"] = -1.0 if cutoff is None else float(cutoff)
    if "cutoff_mode" in accepts:
        opts["cutoff_mode"] = parse_cutoff_mode(cutoff_mode)
    if "renorm" in accepts:
        if renorm is True:
            opts["renorm"] = RENORM_LOOKUP.get(
                parse_cutoff_mode(cutoff_mode), 0)
        else:
            opts["renorm"] = 0 if renorm is None else int(renorm)
    if "info" in accepts:
        opts["info"] = info

    if isinstance(x, np.ndarray) and x.dtype != object and \
            method in ("svd", "qr"):
        from .contraction import get_contract_backend

        if get_contract_backend() == "numpy":
            return _array_split_host(x, method, **opts)

    if not isinstance(x, torch.Tensor):
        from .backend import resolve_device, to_device

        x = to_device(x, device=resolve_device(None))
    # materialise torch's lazy conjugates (``dag``'s), so that a factor is
    # a plain tensor
    return tuple(None if f is None else f.resolve_conj()
                 for f in fn(x, **opts))


def _array_split_host(x, method, absorb="both", max_bond=-1, cutoff=-1.0,
                      cutoff_mode=4, renorm=0, info=None):
    """The ``svd`` and ``qr`` drivers in numpy, for host tensors under
    ``contract_backend("numpy")``."""
    if method == "qr":
        if absorb == "left":
            return lq_stabilized(x)
        return qr_stabilized(x)
    U, s, VH = np.linalg.svd(x, full_matrices=False)
    return _trim_and_renorm(U, s, VH, cutoff=cutoff, cutoff_mode=cutoff_mode,
                            max_bond=max_bond, absorb=absorb, renorm=renorm,
                            info=info)


@register_split_driver("svd")
def svd_truncated(x, cutoff=-1.0, cutoff_mode=4, max_bond=-1, absorb="both",
                  renorm=0, info=None):
    """Truncated SVD (on CUDA by the driver of :func:`_svd_driver`)."""
    if isinstance(x, np.ndarray):
        U, s, VH = np.linalg.svd(x, full_matrices=False)
    else:
        U, s, VH = safe_svd(x)
    return _trim_and_renorm(
        U, s, VH, cutoff=cutoff, cutoff_mode=cutoff_mode, max_bond=max_bond,
        absorb=absorb, renorm=renorm, info=info,
    )


def _svd_via_eig(x, gram_side):
    """SVD via a hermitian eigendecomposition of the gram matrix on
    ``gram_side``, singular values descending."""
    if gram_side == "left":
        s, s_safe, U = _gram_eigh(x @ dag(x))
        return U, s, lddiv(s_safe, dag(U) @ x)
    s, s_safe, V = _gram_eigh(dag(x) @ x)
    return rddiv(x @ V, s_safe), s, dag(V)


@register_split_driver("svd:eig")
def svd_via_eig_truncated(x, cutoff=-1.0, cutoff_mode=4, max_bond=-1,
                          absorb="both", renorm=0, info=None):
    m, n = x.shape[-2:]
    U, s, VH = _svd_via_eig(x, "left" if m <= n else "right")
    return _trim_and_renorm(
        U, s, VH, cutoff=cutoff, cutoff_mode=cutoff_mode, max_bond=max_bond,
        absorb=absorb, renorm=renorm, info=info,
    )


def _rand_range_finder(x, k, q, seed=None, gen=None):
    """Orthonormal Q (m, k) approximately spanning the top-k column space
    of ``x``, with ``q`` power iterations; the sketch is drawn from
    ``gen``, else from a generator of ``x``'s device seeded ``seed``
    (quimb_tpu draws from JAX's PRNG)."""
    from ..gen.rand import _generator, _randn_from

    if gen is None:
        gen = _generator(x.device, seed)
    G = _randn_from(gen, (*x.shape[:-2], x.shape[-1], k), x.real.dtype, 1.0,
                    0.0, "normal", x.device).to(x.dtype)
    Q, _ = safe_qr(x @ G)
    for _ in range(q):
        Z, _ = safe_qr(dag(x) @ Q)
        Q, _ = safe_qr(x @ Z)
    return Q


def estimate_rank(x, eps=1e-10, k_start=16, k_max=None, q=2, seed=None):
    """The numerical rank of ``x`` at relative singular-value threshold
    ``eps``, by randomized range sketches that double in size until the
    smallest captured singular value falls below ``eps * s_max``
    (reference ``estimate_rank`` rand_linalg.py:302). Each sketch reads
    its spectrum to the host."""
    from ..gen.rand import _generator

    gen = _generator(x.device, seed)
    m, n = x.shape[-2:]
    full = min(m, n)
    k_max = full if k_max is None else k_max
    k = min(k_start, full)
    while True:
        Q = _rand_range_finder(x, k, q, gen=gen)
        s = torch.linalg.svdvals(dag(Q) @ x)
        below = s < eps * s[0]
        if bool(torch.any(below)):
            return int(torch.argmax(below.to(torch.int8)))
        if k >= k_max:
            return int(full if k >= full else k)
        k = min(2 * k, k_max, full)


@register_split_driver("svd:rand", accepts=_FULL_SPLIT_OPTS | {"q", "p"})
def svd_rand_truncated(x, cutoff=-1.0, cutoff_mode=4, max_bond=-1,
                       absorb="both", renorm=0, info=None, q=2, p=10):
    """Randomized truncated SVD; only beneficial with ``max_bond``."""
    m, n = x.shape[-2:]
    if max_bond is None or max_bond <= 0:
        return svd_truncated(x, cutoff, cutoff_mode, -1, absorb, renorm,
                             info)
    k = min(max_bond + p, m, n)
    Q = _rand_range_finder(x, k, q)
    Ub, s, VH = safe_svd(dag(Q) @ x)
    return _trim_and_renorm(
        Q @ Ub, s, VH, cutoff=cutoff, cutoff_mode=cutoff_mode,
        max_bond=max_bond, absorb=absorb, renorm=renorm, info=info,
    )


# the reference's iterative sparse drivers: dense arrays here
register_split_driver("svds")(svd_rand_truncated)
register_split_driver("isvd", accepts=_FULL_SPLIT_OPTS | {"q", "p"})(
    svd_rand_truncated)
register_split_driver("rsvd", accepts=_FULL_SPLIT_OPTS | {"q", "p"})(
    svd_rand_truncated)


@register_split_driver("qr", accepts=("absorb",))
def qr_driver(x, absorb="right"):
    if absorb == "left":
        return lq_stabilized(x)
    return qr_stabilized(x)


@register_split_driver("qr:cholesky", accepts=())
def qr_cholesky(x):
    """Cholesky-QR: Q = x R^-1 with R = chol(x†x)†, the gram matrix
    shifted by eps·tr for rank safety."""
    G = dag(x) @ x
    eps = torch.finfo(x.real.dtype).eps
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1).real
    G = G + (eps * tr)[..., None, None] * torch.eye(
        G.shape[-1], dtype=G.dtype, device=G.device)
    L = torch.linalg.cholesky(G)
    Q = torch.linalg.solve_triangular(L, dag(x), upper=False)
    return dag(Q), None, dag(L)


@register_split_driver("eigh", accepts=_FULL_SPLIT_OPTS | {"positive",
                                                            "shift"})
def eigh_truncated(x, cutoff=-1.0, cutoff_mode=4, max_bond=-1, absorb="both",
                   renorm=0, info=None, positive=0, shift=False):
    """SVD-like split via a hermitian eigendecomposition; ``x`` must be
    hermitian. Without ``positive`` the values are ordered by magnitude."""
    if shift:
        rel = torch.finfo(x.real.dtype).eps if shift is True else float(shift)
        tr = torch.diagonal(x, dim1=-2, dim2=-1).sum(-1)
        x = x + (rel * tr)[..., None, None] * torch.eye(
            x.shape[-1], dtype=x.dtype, device=x.device)
    s, U = torch.linalg.eigh(x)
    if not positive:
        idx = torch.argsort(-torch.abs(s), dim=-1, stable=True)
        s = torch.take_along_dim(s, idx, dim=-1)
        U = torch.take_along_dim(U, idx[..., None, :], dim=-1)
    else:
        s, U = torch.flip(s, (-1,)), torch.flip(U, (-1,))
    if positive and absorb in ("both", "lsqrt", "rsqrt"):
        s = torch.clamp(s, min=0.0)
    return _trim_and_renorm(
        U, s, dag(U), cutoff=cutoff, cutoff_mode=cutoff_mode,
        max_bond=max_bond, absorb=absorb, renorm=renorm,
        use_abs=not positive, info=info,
    )


register_split_driver("eigsh", accepts=_FULL_SPLIT_OPTS | {"positive",
                                                            "shift"})(
    eigh_truncated)


@register_split_driver("cholesky", accepts=())
def cholesky_split(x):
    """x = L @ L†, for positive-definite hermitian x."""
    L = torch.linalg.cholesky(x)
    return L, None, dag(L)


@register_split_driver("polar_right", accepts=())
def polar_right(x):
    """Polar decomposition x = W @ P (W isometric, P positive hermitian)."""
    U, s, VH = safe_svd(x)
    return U @ VH, None, dag(VH) @ ldmul(s, VH)


@register_split_driver("polar_left", accepts=())
def polar_left(x):
    """Polar decomposition x = P @ W."""
    U, s, VH = safe_svd(x)
    return rdmul(U, s) @ dag(U), None, U @ VH


@register_split_driver("lu", accepts=("cutoff", "cutoff_mode"))
def lu_truncated(x, cutoff=-1.0, cutoff_mode=4):
    """LU split x = (P L) U, optionally dropping jointly small columns of
    P L and rows of U (only the abs and rel cutoffs). The kept columns
    are read to the host."""
    P, L, U = torch.linalg.lu(x)
    PL = P @ L
    if cutoff > 0.0:
        ss = torch.linalg.norm(PL, dim=-2) * torch.linalg.norm(U, dim=-1)
        if cutoff_mode == 1:
            keep = ss > cutoff
        elif cutoff_mode == 2:
            keep = ss > cutoff * torch.max(ss)
        else:
            raise ValueError(
                "lu_truncated only supports cutoff modes 'abs' and 'rel'"
            )
        (idx,) = np.nonzero(keep.cpu().numpy())
        idx = torch.as_tensor(idx, device=x.device)
        PL = PL[..., :, idx]
        U = U[..., idx, :]
    return PL, None, U


# -- isometrization ------------------------------------------------------------


def _pad_square(x):
    m, n = x.shape[-2:]
    d = max(m, n)
    return torch.nn.functional.pad(x, (0, d - n, 0, d - m)), d


def isometrize_qr(x):
    """Isometrize via QR with the positive-diagonal convention."""
    Q, R = safe_qr(x)
    return Q * sgn(torch.diagonal(R, dim1=-2, dim2=-1))[..., None, :]


def isometrize_svd(x):
    U, _, VH = safe_svd(x)
    return U @ VH


def isometrize_exp(x):
    """U = expm(X - X†) with rectangular x zero-completed first."""
    m, n = x.shape[-2:]
    xp, _ = _pad_square(x)
    return torch.linalg.matrix_exp(xp - dag(xp))[..., :m, :n]


def isometrize_cayley(x):
    """Cayley transform of (X - X†)/2, zero-completed to square."""
    m, n = x.shape[-2:]
    xp, d = _pad_square(x)
    A = (xp - dag(xp)) / 2.0
    Id = torch.eye(d, dtype=x.dtype, device=x.device)
    return torch.linalg.solve(Id - A, Id + A)[..., :m, :n]


def isometrize_householder(X):
    """The product of the Householder reflectors held in the strictly
    lower triangle of X (LAPACK's ``orgqr``, as in quimb_tpu)."""
    X = torch.tril(X, -1)
    tau = 2.0 / (1.0 + torch.sum(torch.conj(X) * X, dim=-2))
    return torch.linalg.householder_product(X, tau.to(X.dtype))


def isometrize_mgs(A):
    """Modified Gram-Schmidt, as quimb_tpu computes it: its stabilised QR
    (the same projector)."""
    return isometrize_qr(A)


_ISOMETRIZE_METHODS = {
    "qr": isometrize_qr,
    "svd": isometrize_svd,
    "mgs": isometrize_mgs,
    "exp": isometrize_exp,
    "cayley": isometrize_cayley,
    "householder": isometrize_householder,
}


def isometrize(x, method="qr"):
    """Project ``x`` into isometric form using ``method``."""
    return _ISOMETRIZE_METHODS[method](x)


# -- reduced factors and oblique projectors ----------------------------------


def squared_op_to_reduced_factor(x2, right=True):
    """Given the square of an operator ``x2 = x† x`` (or ``x x†``), a
    reduced factor ``R`` with ``R† R = x2`` (right) or ``R R† = x2``
    (left)."""
    s2, W = torch.linalg.eigh(x2)
    s = torch.sqrt(torch.clamp(s2, min=0.0))
    return ldmul(s, dag(W)) if right else rdmul(W, s)


def compute_oblique_projectors(Rl, Rr, max_bond, cutoff, absorb="both",
                               cutoff_mode=4, **split_opts):
    """Oblique projectors ``Pl``, ``Pr`` for a bond with left and right
    reduced factors ``Rl``, ``Rr``: inserting ``Pl @ Pr`` compresses the
    bond to ``max_bond``."""
    max_bond = -1 if max_bond is None else max_bond
    U, s, VH = svd_truncated(
        Rl @ Rr, cutoff=cutoff, cutoff_mode=cutoff_mode, max_bond=max_bond,
        absorb=None, **split_opts,
    )
    sqs = torch.sqrt(s)
    safe = torch.where(sqs > 0, sqs, torch.ones_like(sqs))
    Pl = Rr @ rddiv(dag(VH), safe)
    Pr = lddiv(safe, dag(U)) @ Rl
    return Pl, Pr


def similarity_compress(X, max_bond, renorm=False, method="eigh"):
    """``(Cl, Cr)`` compressing a square bond-environment operator ``X``
    to ``max_bond`` by a similarity transform: ``Cr @ X @ Cl`` acts on
    the compressed bond, and ``Cl @ Cr`` is the projector to insert
    (methods ``eigh``, ``svd``, and ``biorthog`` on the host)."""
    if X.shape[-1] <= max_bond:
        eye = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
        return eye, eye
    if method == "eigh":
        el, ev = torch.linalg.eigh((X + dag(X)) / 2)
        sel = torch.argsort(-torch.abs(el), stable=True)[:max_bond]
        Cl = ev[:, sel]
        Cr = dag(Cl)
    elif method == "svd":
        U, _, _ = safe_svd(X)
        Cl = U[:, :max_bond]
        Cr = dag(Cl)
    elif method == "biorthog":
        import scipy.linalg as sla

        from .backend import to_host

        Xh = to_host(X)
        el, vl, vr = sla.eig(Xh, left=True, right=True)
        sel = np.argsort(-np.abs(el))[:max_bond]
        Cl_ = vr[:, sel]
        Cr_ = np.linalg.solve(vl[:, sel].conj().T @ Cl_,
                              vl[:, sel].conj().T)
        if not (np.iscomplexobj(Xh) or np.abs(np.imag(Cl_)).max() > 1e-12):
            Cl_, Cr_ = np.real(Cl_), np.real(Cr_)
        Cl = torch.as_tensor(Cl_, device=X.device)
        Cr = torch.as_tensor(Cr_, device=X.device)
    else:
        raise ValueError(f"unknown similarity_compress method {method}")
    if renorm:
        Cl = Cl * (torch.trace(X) / torch.trace(Cr @ (X @ Cl)))
    return Cl, Cr
