"""Tensor-network algorithms of quimb_torch: the object layer (``Tensor``,
``TensorNetwork`` and their functions, as quimb_tpu's ``tensor/__init__.py``
exports them), the circuit simulators, the MPS / MPO layer with the 1D
engines that take it, the PEPS / PEPO layer with the 2D engines, the
lattice edge generators and the arbitrary-geometry layer."""

from ..ops.contraction import (
    array_contract,
    array_contract_expression,
    array_contract_path,
    array_contract_tree,
    contract_backend,
    contract_strategy,
    get_contract_backend,
    get_contract_strategy,
    get_symbol,
    inds_to_eq,
    set_contract_backend,
    set_contract_strategy,
)
from ..utils import oset
from . import networking  # noqa: F401
from .circuit import *  # noqa: F401,F403
from .circuit import __all__ as _circuit_all
from .core import (
    COPY_tensor,
    IsoTensor,
    PArray,
    PTensor,
    Tensor,
    TensorNetwork,
    bonds,
    bonds_size,
    connect,
    group_inds,
    new_bond,
    rand_uuid,
    tensor_balance_bond,
    tensor_canonize_bond,
    tensor_compress_bond,
    tensor_contract,
    tensor_direct_product,
    tensor_fuse_squeeze,
    tensor_gauge_simple_bond,
    tensor_make_single_bond,
    tensor_network_sum,
    tensor_split,
)
from .geometry import (
    edges_1d_chain,
    edges_2d_hexagonal,
    edges_2d_kagome,
    edges_2d_square,
    edges_2d_triangular,
    edges_2d_triangular_rectangular,
    edges_3d_cubic,
    edges_3d_diamond,
    edges_3d_diamond_cubic,
    edges_3d_pyrochlore,
    edges_rand_reg,
    edges_tree_rand,
)
from .tn1d import *  # noqa: F401,F403
from .tn1d import __all__ as _tn1d_all
from .tn2d import *  # noqa: F401,F403
from .tn2d import __all__ as _tn2d_all
from .tnag import *  # noqa: F401,F403
from .tnag import __all__ as _tnag_all

__all__ = [
    "COPY_tensor",
    "IsoTensor",
    "PArray",
    "PTensor",
    "Tensor",
    "TensorNetwork",
    "bonds",
    "bonds_size",
    "connect",
    "group_inds",
    "new_bond",
    "oset",
    "rand_uuid",
    "tensor_balance_bond",
    "tensor_canonize_bond",
    "tensor_compress_bond",
    "tensor_contract",
    "tensor_direct_product",
    "tensor_fuse_squeeze",
    "tensor_gauge_simple_bond",
    "tensor_make_single_bond",
    "tensor_network_sum",
    "tensor_split",
    "array_contract",
    "array_contract_expression",
    "array_contract_path",
    "array_contract_tree",
    "contract_backend",
    "contract_strategy",
    "get_contract_backend",
    "get_contract_strategy",
    "get_symbol",
    "inds_to_eq",
    "set_contract_backend",
    "set_contract_strategy",
    "edges_1d_chain",
    "edges_2d_hexagonal",
    "edges_2d_kagome",
    "edges_2d_square",
    "edges_2d_triangular",
    "edges_2d_triangular_rectangular",
    "edges_3d_cubic",
    "edges_3d_diamond",
    "edges_3d_diamond_cubic",
    "edges_3d_pyrochlore",
    "edges_rand_reg",
    "edges_tree_rand",
    *_circuit_all,
    *_tn1d_all,
    *_tn2d_all,
    *_tnag_all,
]
