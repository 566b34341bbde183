"""Iterative linear algebra of quimb_torch: Lanczos, stochastic Lanczos
quadrature and randomized SVDs."""

from .lanczos import (
    eigh_lanczos,
    eigsh,
    expm_multiply_krylov,
    lobpcg_block,
)
from .approx_spectral import (
    approx_spectral_function,
    entropy_subsys_approx,
    logneg_subsys_approx,
    negativity_subsys_approx,
    norm_ppt_subsys_approx,
    tr_abs_approx,
    tr_exp_approx,
    tr_sqrt_approx,
    tr_sqrt_subsys_approx,
    tr_xlogx_approx,
    xlogx,
)
from .rand_linalg import (
    count_svdvals_needed,
    estimate_rank,
    isvd,
    rsvd,
    rsvd_iterate,
)

__all__ = [
    "eigh_lanczos", "eigsh", "expm_multiply_krylov", "lobpcg_block",
    "approx_spectral_function", "count_svdvals_needed",
    "entropy_subsys_approx", "estimate_rank", "isvd",
    "logneg_subsys_approx", "negativity_subsys_approx",
    "norm_ppt_subsys_approx", "rsvd", "rsvd_iterate", "tr_abs_approx",
    "tr_exp_approx", "tr_sqrt_approx", "tr_sqrt_subsys_approx",
    "tr_xlogx_approx", "xlogx",
]
