"""Phases 28 and 30(g) of chip_smoke.py alone on one CUDA GPU: the
28-qubit CircuitDense with its xeb and simulate_counts checks, then
DMRGX under shard_onto and SpinHam1D.build_dense in a one-rank NCCL
world. Run from the root of the repository:

    python3 scripts/phase28_30g_alone.py
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402
from quimb_torch.parallel import get_mesh  # noqa: E402

if __name__ == "__main__":
    t0 = time.perf_counter()
    cs.check_device()
    print(cs._power(), flush=True)
    cs.run_circuit_dense()
    torch.cuda.empty_cache()
    get_mesh()
    cs._sharded_dmrgx_and_spin_ham()
    dist.destroy_process_group()
    print(f"phases 28 and 30(g): {time.perf_counter() - t0:.1f} s",
          flush=True)
