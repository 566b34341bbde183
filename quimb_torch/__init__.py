"""quimb_torch: the PyTorch and CUDA port of quimb_tpu.

It holds quimb_tpu's 1D engines on lists of site tensors: the builders
(``MPO_ham_heis``, ``MPS_rand_state``, the product states and the
``ham_1d_*`` local Hamiltonians), the ground-state searches ``DMRG2``,
``DMRG1`` and ``ParallelDMRG``, with every effective-Hamiltonian matvec
of a GPU run in a hand-written CUDA kernel, and ``TEBD`` time evolution.
Every builder and entry point puts its tensors on the GPU unless it is
given another ``device``, such as ``"cpu"``. The package imports torch,
never JAX.
"""

from . import config  # noqa: F401  (precision setup, before any product)
from .tensor import *  # noqa: F401,F403
from .tensor import __all__  # noqa: F401
