"""quimb_torch.operator: second-quantised sparse operators (port of
``quimb_tpu/operator/``, reference ``quimb/operator/``): Hilbert spaces
with symmetry sectors, the term builder with its host matrices, MPOs and
the matrix-free device operator ``CoupledHam``, the edge-list models and
the nearest-neighbour PEPO."""

from .hilbertspace import HilbertSpace
from .builder import SparseOperatorBuilder, add_mpo, get_mat
from .configdevice import CoupledHam
from .models import (
    fermi_hubbard_from_edges,
    fermi_hubbard_spinless_from_edges,
    heisenberg_from_edges,
    rand_operator,
)
from .pepobuilder import PEPO_nearest_neighbor, pepo_nearest_neighbor

__all__ = [
    "CoupledHam",
    "HilbertSpace",
    "SparseOperatorBuilder",
    "add_mpo",
    "fermi_hubbard_from_edges",
    "fermi_hubbard_spinless_from_edges",
    "get_mat",
    "heisenberg_from_edges",
    "rand_operator",
    "PEPO_nearest_neighbor",
    "pepo_nearest_neighbor",
]
