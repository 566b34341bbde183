"""1D tensor networks: builders and DMRG on uniform site-tensor lists."""

from .builders import MPO_ham_heis, MPS_rand_state
from .dmrg import DMRG1, DMRG2

__all__ = ["DMRG1", "DMRG2", "MPO_ham_heis", "MPS_rand_state"]
