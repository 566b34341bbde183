"""quimb_torch.parallel: the multi-device layer, on ``torch.distributed``.

The port of ``quimb_tpu/parallel/``. quimb_tpu shards arrays over a
``jax.sharding.Mesh`` driven by one process; here one process runs per
device (a rank of ``torch.distributed``), over a ``DeviceMesh`` with the
same axis names, and the collectives are explicit
(:mod:`quimb_torch.parallel.mesh`).

====================  =============================================
reference (MPI)        quimb_torch.parallel
====================  =============================================
mpi_launcher pools     ``torchrun`` + ``distributed_init()``;
                       ``get_mesh()`` (a one-rank world if none)
CSR row slabs          ``ShardedSparseHam`` (a row slab per rank)
``comm.Bcast``         ``broadcast`` / replicated DTensors
``gather_petsc_array`` ``all_gather`` of the rows
SLEPc Krylov-Schur     ``eigh_lanczos_sharded``
SLEPc MFN expm         ``expm_multiply_sharded``
MPI-parallel SLQ       ``approx_spectral_sharded`` (probes per rank)
sliced contraction     ``contract_sliced`` (slices per rank, batched,
                       ``all_reduce``)
====================  =============================================

``dryrun_multichip(n)`` runs one step of each sharded path on a world of
``n`` ranks. The host executor pools are in
:mod:`quimb_torch.parallel.pools`.
"""

from .dryrun import dryrun_multichip
from .mesh import (
    ShardedSparseHam,
    approx_spectral_sharded,
    choose_sliced_inds,
    contract_sliced,
    contract_tn_mesh,
    distributed_init,
    eigh_lanczos_sharded,
    expm_multiply_sharded,
    get_mesh,
    get_mesh_2d,
    mesh_put,
)
from .pools import (
    can_use_mpi_pool,
    get_mpi_pool,
    get_thread_pool,
)

__all__ = [
    "ShardedSparseHam",
    "approx_spectral_sharded",
    "choose_sliced_inds",
    "contract_sliced",
    "contract_tn_mesh",
    "distributed_init",
    "dryrun_multichip",
    "eigh_lanczos_sharded",
    "expm_multiply_sharded",
    "get_mesh",
    "get_mesh_2d",
    "mesh_put",
    "can_use_mpi_pool",
    "get_mpi_pool",
    "get_thread_pool",
]
