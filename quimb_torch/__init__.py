"""quimb_torch: the PyTorch and CUDA port of quimb_tpu.

The first slice is the DMRG2 main path: ``MPO_ham_heis`` builds the
Hamiltonian, ``MPS_rand_state`` the start state and ``DMRG2`` sweeps,
with the effective-Hamiltonian matvec in a hand-written CUDA kernel on
the GPU. The package imports torch, never JAX.
"""

from . import config  # noqa: F401  (precision setup, before any product)
from .tensor import DMRG1, DMRG2, MPO_ham_heis, MPS_rand_state

__all__ = ["DMRG1", "DMRG2", "MPO_ham_heis", "MPS_rand_state"]
