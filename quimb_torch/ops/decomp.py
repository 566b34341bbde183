"""Truncated SVD and sign-fixed QR / LQ, the splits of the DMRG main path.

Port of the matching parts of ``quimb_tpu/ops/decomp.py``. The TPU's
square-padding shims and its triangular-matmul cumsum are not needed:
cuSOLVER and LAPACK take rectangular SVD and QR as they are.
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
    # On CUDA, cuSOLVER's default Jacobi driver (gesvdj, with its own
    # fallback) returned float32 factors of the 512 x 512 DMRG splits with
    # ||U^T U - I|| ~ 1e-3 on an H100, and the sweep energies drifted up
    # by 1e-3 per sweep; gesvd keeps it at ~6e-6 and was faster there.
    driver = "gesvd" if x.is_cuda else None
    U, s, VH = torch.linalg.svd(x, full_matrices=False, driver=driver)
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
    csp = torch.cumsum(sp, dim=-1)
    tot = csp[..., -1:]
    # exclusive prefix sums: value i is kept if the sum *before* it has
    # not yet crossed the threshold (the reference counts `above + 1`)
    csp_exc = csp - sp

    idx = torch.arange(k, device=s.device)
    if cutoff_mode == 1:
        mask = skept > cutoff
    elif cutoff_mode == 2:
        mask = skept > cutoff * skept[..., 0:1]
    elif cutoff_mode in (4, 6):
        mask = csp_exc[..., :k] < tot * (1 - cutoff)
    else:
        mask = csp_exc[..., :k] < tot - cutoff
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
