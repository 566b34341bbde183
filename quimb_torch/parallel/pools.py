"""Host executor pools (reference ``quimb/linalg/mpi_launcher.py``:
``get_mpi_pool`` :96, ``can_use_mpi_pool`` :52; ``get_thread_pool``
core.py:84), with quimb_tpu's semantics (``quimb_tpu/parallel/pools.py``).

The work on the card runs in ranks of ``torch.distributed``
(:mod:`quimb_torch.parallel.mesh`); these pools are for host-side fan-out
(local expectations, the terms of a multi-loss), so code written against
the reference's ``pool.submit(...)`` idiom runs unchanged. ``get_mpi_pool``
returns the same process-local executor: a multi-process run is one
``torch.distributed`` program per rank, started by a launcher such as
``torchrun``, not an MPI spawn.
"""

import concurrent.futures
import functools
import os


@functools.lru_cache(8)
def get_thread_pool(num_workers=None):
    """A process-wide thread pool of ``num_workers`` threads (by default
    ``QUIMB_NUM_THREAD_WORKERS``, else the CPU count), cached per count."""
    if num_workers is None:
        num_workers = int(os.environ.get(
            "QUIMB_NUM_THREAD_WORKERS", os.cpu_count() or 1
        ))
    return concurrent.futures.ThreadPoolExecutor(num_workers)


def can_use_mpi_pool():
    """Whether an MPI pool is available: never; ranks of
    ``torch.distributed`` take its place."""
    return False


def get_mpi_pool(num_workers=None, num_threads=1):
    """The host thread pool of :func:`get_thread_pool`, standing in for the
    reference's ``MPIPoolExecutor``."""
    return get_thread_pool(num_workers)


__all__ = ["get_thread_pool", "can_use_mpi_pool", "get_mpi_pool"]
