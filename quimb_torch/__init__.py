"""quimb_torch: the PyTorch and CUDA port of quimb_tpu.

It holds quimb_tpu's MPS / MPO object layer (``MatrixProductState``,
``MatrixProductOperator``, their builders ``MPS_*`` / ``MPO_*`` and the
``ham_1d_*`` local Hamiltonians) and the 1D engines that take it: the
ground-state searches ``DMRG2``, ``DMRG1``, ``DMRGX`` and
``ParallelDMRG``, with every effective-Hamiltonian matvec of a GPU run in
a hand-written CUDA kernel, and ``TEBD`` time evolution.
And the exact layer: sparse Hamiltonians (``ham_heis``) applied term by
term on the device (``device_operator``), computational-basis kets, the
Lanczos ``groundenergy`` / ``groundstate`` / ``eigensystem_partial``, and
Krylov ``expm_multiply`` and ``Evolution``. And the tensor-network object
layer (``Tensor``, ``TensorNetwork``, simplification, gating) with the exact
circuit simulator ``Circuit`` and the MPS simulators ``CircuitMPS``,
``CircuitPermMPS`` and ``CircuitMPSLazy``. Every builder and entry point
puts its tensors on the GPU unless it is given another ``device``, such as
``"cpu"``. The package imports torch, never JAX.
"""

from . import config  # noqa: F401  (precision setup, before any product)
from .core import device_operator
from .evo import Evolution
from .gen.operators import ham_heis
from .gen.states import computational_state, neel_state
from .linalg.base_linalg import (
    eigensystem_partial,
    expm_multiply,
    groundenergy,
    groundstate,
)
from .tensor import *  # noqa: F401,F403
from .tensor import __all__ as _tensor_all

__all__ = [*_tensor_all, "Evolution", "computational_state",
           "device_operator", "eigensystem_partial", "expm_multiply",
           "groundenergy", "groundstate", "ham_heis", "neel_state"]
