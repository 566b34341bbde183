"""Phase 30 of ``chip_smoke.py`` alone on one CUDA GPU: the float64 DMRG2
main path (phase 3's L=128, chi=256 state), then 30(a), the sharded sweeps
against the unsharded ones, and 30(b)-(f), with REFBASE's <Z_0>
checkpoints standing for phase 11's expm values. Run from the root of the
repository::

    python3 scripts/phase30_alone.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    t0 = time.perf_counter()
    cs.check_device()
    cs.build_kernels()
    dmrg, _ = cs.run_main_path(torch.float64)
    print("sharded launches", cs.run_sharded_dmrg(dmrg), flush=True)
    del dmrg
    torch.cuda.empty_cache()
    cs.run_multidevice(list(cs._exact_reference()[1]))
    print(f"phase 30 alone: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
