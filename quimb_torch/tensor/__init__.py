"""Tensor-network algorithms of quimb_torch."""

from .tn1d import DMRG1, DMRG2, MPO_ham_heis, MPS_rand_state

__all__ = ["DMRG1", "DMRG2", "MPO_ham_heis", "MPS_rand_state"]
