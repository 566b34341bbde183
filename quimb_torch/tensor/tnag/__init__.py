"""Arbitrary-geometry tensor networks (port of quimb_tpu's ``tensor/tnag/``):
networks on any graph, their builders and compressions, and
``TEBDGen`` / ``SimpleUpdateGen``."""

from .core import (
    LatticeBondMap,
    TensorNetworkGen,
    TensorNetworkGenOperator,
    TensorNetworkGenVector,
    create_lazy_edge_map,
    edge_coloring,
    tensor_network_ag_gate,
    tensor_network_ag_gate_simple,
    tensor_network_ag_sum,
    tensor_network_align,
    tensor_network_apply_op_op,
    tensor_network_apply_op_vec,
)
from .builders import (
    HTN_classical_partition_function_from_edges,
    TN_rand_from_edges,
    HTN_from_clauses,
    TN3D_classical_ising_partition_function,
    TN_classical_partition_function_from_edges,
    TN_dimer_covering_from_edges,
    TN_from_edges_and_fill_fn,
    TN_from_edges_empty,
    TN_from_edges_rand,
    TN_rand_reg,
    cnf_file_parse,
)
from .compress import (
    tensor_network_ag_compress,
    tensor_network_ag_compress_local_early,
    tensor_network_ag_compress_local_late,
    tensor_network_ag_compress_projector,
    tensor_network_ag_compress_superorthogonal,
)
from .tebd import LocalHamGen, SimpleUpdateGen, TEBDGen, ham_gen_heis

__all__ = [
    "LatticeBondMap",
    "create_lazy_edge_map",
    "tensor_network_ag_gate",
    "tensor_network_ag_gate_simple",
    "tensor_network_ag_sum",
    "tensor_network_align",
    "tensor_network_apply_op_op",
    "tensor_network_apply_op_vec",
    "HTN_from_clauses",
    "TN_dimer_covering_from_edges",
    "TN3D_classical_ising_partition_function",
    "TN_rand_from_edges",
    "cnf_file_parse",
    "tensor_network_ag_compress",
    "tensor_network_ag_compress_local_early",
    "tensor_network_ag_compress_local_late",
    "tensor_network_ag_compress_projector",
    "tensor_network_ag_compress_superorthogonal",
    "TensorNetworkGen",
    "TensorNetworkGenOperator",
    "TensorNetworkGenVector",
    "edge_coloring",
    "HTN_classical_partition_function_from_edges",
    "TN_classical_partition_function_from_edges",
    "TN_from_edges_and_fill_fn",
    "TN_from_edges_empty",
    "TN_from_edges_rand",
    "TN_rand_reg",
    "LocalHamGen",
    "SimpleUpdateGen",
    "TEBDGen",
    "ham_gen_heis",
]
