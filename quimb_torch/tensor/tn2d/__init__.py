"""2D tensor networks: PEPS / PEPO, boundary contraction (every mode,
``"full-bond"`` included) and environments, HOTRG and CTMRG, the 2D local
Hamiltonians, TEBD2D, SimpleUpdate and FullUpdate."""

from .builders import (
    PEPO_identity,
    PEPO_product_operator,
    PEPO_rand,
    PEPS_computational_state,
    PEPS_product_state,
    PEPS_rand,
    PEPS_zeros,
)
from .compress import tensor_network_2d_compress
from .core import (
    PEPO,
    PEPS,
    Rotator2D,
    TensorNetwork2D,
    TensorNetwork2DVector,
    contract_ctmrg,
    contract_hotrg,
    gen_2d_bonds,
)
from .tebd import (
    TEBD2D,
    FullUpdate,
    LocalHam2D,
    SimpleUpdate,
    ham_2d_heis,
    ham_2d_ising,
    ham_2d_j1j2,
)

__all__ = [
    "tensor_network_2d_compress",
    "Rotator2D",
    "PEPO",
    "PEPS",
    "TensorNetwork2D",
    "TensorNetwork2DVector",
    "contract_ctmrg",
    "contract_hotrg",
    "gen_2d_bonds",
    "PEPO_identity",
    "PEPO_product_operator",
    "PEPO_rand",
    "PEPS_computational_state",
    "PEPS_product_state",
    "PEPS_rand",
    "PEPS_zeros",
    "TEBD2D",
    "FullUpdate",
    "LocalHam2D",
    "SimpleUpdate",
    "ham_2d_heis",
    "ham_2d_ising",
    "ham_2d_j1j2",
]
