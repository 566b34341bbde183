"""1D tensor networks: MPS / MPO objects, their builders, DMRG and TEBD."""

from .builders import (
    MPO_ham_bilinear_biquadratic,
    MPO_ham_heis,
    MPO_ham_ising,
    MPO_ham_XXZ,
    MPO_ham_XY,
    MPO_identity,
    MPO_identity_like,
    MPO_product_operator,
    MPO_rand,
    MPO_rand_herm,
    MPO_zeros,
    MPO_zeros_like,
    MPS_COPY,
    MPS_computational_state,
    MPS_ghz_state,
    MPS_neel_state,
    MPS_product_state,
    MPS_rand_computational_state,
    MPS_rand_state,
    MPS_sampler,
    MPS_w_state,
    MPS_zero_state,
    SpinHam1D,
    ham_1d_bilinear_biquadratic,
    ham_1d_heis,
    ham_1d_ising,
    ham_1d_XXZ,
    ham_1d_XY,
)
from .compress import (
    enforce_1d_like,
    mps_gate_with_mpo,
    mps_gate_with_mpo_direct,
    mps_gate_with_mpo_dm,
    mps_gate_with_mpo_lazy,
    mps_gate_with_mpo_zipup,
    mps_gate_with_mpo_zipup_oversample,
    tensor_network_1d_compress,
)
from .core import (
    Dense1D,
    MatrixProductOperator,
    MatrixProductState,
    SuperOperator1D,
    TensorNetwork1D,
    TensorNetwork1DFlat,
    TensorNetwork1DOperator,
    TensorNetwork1DVector,
    TNLinearOperator1D,
    align_TN_1D,
    expec_TN_1D,
    gate_TN_1D,
    superop_TN_1D,
)
from .dmrg import DMRG, DMRG1, DMRG2, DMRGX, MovingEnvironment
from .dmrg_parallel import ParallelDMRG
from .tebd import TEBD, LocalHam1D, OTOC_local

SpinHam = SpinHam1D
NNI = LocalHam1D
NNI_ham_heis = ham_1d_heis
NNI_ham_XY = ham_1d_XY
NNI_ham_ising = ham_1d_ising

__all__ = [
    "DMRG", "DMRG1", "DMRG2", "DMRGX", "Dense1D", "LocalHam1D",
    "MPO_ham_XXZ", "MPO_ham_XY", "MPO_ham_bilinear_biquadratic",
    "MPO_ham_heis", "MPO_ham_ising", "MPO_identity", "MPO_identity_like",
    "MPO_product_operator", "MPO_rand", "MPO_rand_herm", "MPO_zeros",
    "MPO_zeros_like", "MPS_COPY", "MPS_computational_state",
    "MPS_ghz_state", "MPS_neel_state", "MPS_product_state",
    "MPS_rand_computational_state", "MPS_rand_state", "MPS_sampler",
    "MPS_w_state", "MPS_zero_state", "MatrixProductOperator",
    "MatrixProductState", "MovingEnvironment", "NNI", "NNI_ham_XY",
    "NNI_ham_heis", "NNI_ham_ising", "OTOC_local", "ParallelDMRG",
    "SpinHam", "SpinHam1D", "SuperOperator1D", "TEBD", "TNLinearOperator1D",
    "TensorNetwork1D", "TensorNetwork1DFlat", "TensorNetwork1DOperator",
    "TensorNetwork1DVector", "align_TN_1D", "enforce_1d_like",
    "expec_TN_1D", "gate_TN_1D", "ham_1d_XXZ", "ham_1d_XY",
    "ham_1d_bilinear_biquadratic", "ham_1d_heis", "ham_1d_ising",
    "mps_gate_with_mpo", "mps_gate_with_mpo_direct", "mps_gate_with_mpo_dm",
    "mps_gate_with_mpo_lazy", "mps_gate_with_mpo_zipup",
    "mps_gate_with_mpo_zipup_oversample", "superop_TN_1D",
    "tensor_network_1d_compress",
]
