"""1D tensor networks: builders, DMRG and TEBD on uniform site-tensor lists."""

from .builders import (
    MPO_ham_heis,
    MPS_computational_state,
    MPS_neel_state,
    MPS_product_state,
    MPS_rand_state,
    SpinHam1D,
    ham_1d_bilinear_biquadratic,
    ham_1d_heis,
    ham_1d_ising,
    ham_1d_XXZ,
    ham_1d_XY,
)
from .dmrg import DMRG1, DMRG2
from .tebd import TEBD, LocalHam1D

__all__ = [
    "DMRG1", "DMRG2", "LocalHam1D", "MPO_ham_heis", "MPS_computational_state",
    "MPS_neel_state", "MPS_product_state", "MPS_rand_state", "SpinHam1D",
    "TEBD", "ham_1d_bilinear_biquadratic", "ham_1d_heis", "ham_1d_ising",
    "ham_1d_XXZ", "ham_1d_XY",
]
