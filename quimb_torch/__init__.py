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
``CircuitPermMPS`` and ``CircuitMPSLazy``. And the PEPS / PEPO layer:
``PEPS``, ``PEPO``, their builders, boundary contraction, environments and
local expectations, HOTRG and CTMRG contractions, the ``ham_2d_*``
Hamiltonians, ``SimpleUpdate`` (fused colour-class sweeps on the device),
``FullUpdate`` and ``TEBD2D``, and ``CircuitPEPS``. And the
arbitrary-geometry layer: the lattice edge generators (``edges_*``),
``TensorNetworkGen`` / ``GenVector`` / ``GenOperator`` with their builders
(``TN_from_edges_*``), compressions, ``TEBDGen`` and ``SimpleUpdateGen``,
and ``CircuitPEPOSimpleUpdate``. And the 3D layer (``PEPS3D``,
``TensorNetwork3D`` with boundary, CTMRG and HOTRG contraction,
``SimpleUpdate3D``), the network builders (``TN2D_*``, ``TN3D_*``, the
classical Ising partition functions, k-SAT counting networks), the circuit
ansatz generators (``circ_*``) and belief propagation
(``tensor.belief_propagation``: D1BP, D2BP, the batched HV1BP, MPS1BP, the
lazy and generalized variants). And optimisation and fitting
(``TNOptimizer`` by autograd, with the scipy drivers and optax's
first-order rules; ALS, tree and autodiff fits; the fit, src, projector
and bidm 1D compressions; ``MERA``; ``experimental.ClusterUpdateGen``),
the tensor linear operators (``TNLinearOperator``) and the spectral
estimates (stochastic Lanczos quadrature, randomized SVDs). DMRG sweeps a ring of
40 sites or more with its segmented engine, and TEBD evolves rings too.
And the rest of the matrix half: ``operator`` (Hilbert spaces with
symmetry sectors, the term builder and the matrix-free sector operator
``CoupledHam``), ``calc`` (entropies, negativities, fidelities,
measurement, decompositions), ``Evolution`` by RK45, ``solve`` and Krylov
for kets and density operators, the rest of ``core``, ``linalg`` and
``gen``, ``gates`` and the dense circuit simulator ``CircuitDense``; their
names resolve at the top level on first use, as quimb_tpu's do, with
``utils``' and ``utils_plot``'s. And ``experimental`` (variational Monte
Carlo batched over chains, the CP decomposition, CTMRG, network marginals,
the isometric network builder) and the drawing code, which imports
matplotlib only when something is drawn. And ``parallel``, the
multi-device layer on ``torch.distributed`` (a row-sharded operator,
sliced contraction, ``DMRG.shard_onto`` and ``TEBD.shard_onto``), with
the host pools ``get_thread_pool`` and ``get_mpi_pool``. The default dtype is a
thread-local stack (``config.default_dtype``, ``QUIMB_TORCH_DTYPE``) that
every builder reads when called.
Every builder and entry point
puts its tensors on the GPU unless it is given another ``device``, such as
``"cpu"``. The package imports torch, never JAX.
"""

from . import config  # noqa: F401  (precision setup, before any product)
from .calc import heisenberg_energy
from .core import device_operator
from .evo import Evolution
from .gen.operators import ham_heis
from .gen.states import computational_state, neel_state
from .linalg import __all__ as _linalg_all
from .linalg.approx_spectral import (
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
from .linalg.rand_linalg import (
    count_svdvals_needed,
    estimate_rank,
    isvd,
    rsvd,
    rsvd_iterate,
)
from .linalg.base_linalg import (
    eigensystem_partial,
    expm_multiply,
    groundenergy,
    groundstate,
)
from .tensor import *  # noqa: F401,F403
from .tensor import __all__ as _tensor_all

__all__ = [*_tensor_all, *_linalg_all, "Evolution", "computational_state",
           "device_operator", "eigensystem_partial", "expm_multiply",
           "groundenergy", "groundstate", "ham_heis", "heisenberg_energy",
           "neel_state"]

# the names of the exact layer's modules, resolved on first use (quimb_tpu's
# lazy index, quimb_tpu/__init__.py)
_LAZY_MODULES = ("core", "calc", "evo", "gen.states", "gen.operators",
                 "gen.rand", "linalg.base_linalg", "linalg.approx_spectral",
                 "linalg.rand_linalg", "gates", "operator", "utils",
                 "utils_plot", "parallel.pools")
_LAZY_INDEX = {}


def __getattr__(name):
    import importlib

    if name == "parallel":
        return importlib.import_module(f"{__name__}.parallel")
    if not _LAZY_INDEX:
        for modname in _LAZY_MODULES:
            mod = importlib.import_module(f"{__name__}.{modname}")
            for key in getattr(mod, "__all__", ()):
                _LAZY_INDEX.setdefault(key, mod)
    if name in _LAZY_INDEX:
        return getattr(_LAZY_INDEX[name], name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
