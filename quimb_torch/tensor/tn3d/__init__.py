"""3D tensor networks: PEPS3D, boundary, CTMRG and HOTRG contraction,
LocalHam3D and SimpleUpdate3D."""

from .core import PEPS3D, TensorNetwork3D, TensorNetwork3DVector, gen_3d_bonds
from .tebd import LocalHam3D, SimpleUpdate3D, ham_3d_heis

__all__ = [
    "PEPS3D",
    "TensorNetwork3D",
    "TensorNetwork3DVector",
    "gen_3d_bonds",
    "LocalHam3D",
    "SimpleUpdate3D",
    "ham_3d_heis",
]
