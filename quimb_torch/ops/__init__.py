"""Kernels, decompositions and host/device transfers of quimb_torch."""

from .decomp import (
    array_split,
    compute_oblique_projectors,
    isometrize,
    lq_stabilized,
    qr_stabilized,
    squared_op_to_reduced_factor,
    svd_truncated,
    svd_truncated_masked,
)

__all__ = [
    "array_split",
    "compute_oblique_projectors",
    "isometrize",
    "lq_stabilized",
    "qr_stabilized",
    "squared_op_to_reduced_factor",
    "svd_truncated",
    "svd_truncated_masked",
]
