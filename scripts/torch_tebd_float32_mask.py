"""The complex64 TEBD quench of chip_smoke.py's phase 10 (L=64, max_bond
64, cutoff 1e-10, 20 fourth-order steps of dt 0.05 from the Néel state),
run twice: with the truncation mask of quimb_tpu and quimb_torch, whose
cumulative sum of the squared singular values runs in float32, and with
that sum in float64. Prints, for each, the largest distance of the 20
half-chain entropies from jcmgray/quimb's complex128 curve
(benchref/REFBASE.json), the discarded weight and |<psi|psi> - 1| every
second step.

Run from the root of the repository::

    python scripts/torch_tebd_float32_mask.py [--device cpu]

The device defaults to the GPU.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import quimb_torch  # noqa: E402
from quimb_torch.ops import decomp  # noqa: E402
from quimb_torch.tensor.tn1d.tebd import _vidal_to_mps  # noqa: E402

L, CHI, STEPS, DT = 64, 64, 20, 0.05


def _float64_mask(mask_absorb):
    def wrapped(U, s, VH, **kw):
        U2, s2, VH2, rank = mask_absorb(U.to(torch.complex128), s.double(),
                                        VH.to(torch.complex128), **kw)
        return U2.to(U.dtype), s2.to(s.dtype), VH2.to(VH.dtype), rank
    return wrapped


def _norm_error(tebd):
    env = np.ones((1, 1))
    for A in _vidal_to_mps(*tebd._vidal):
        A = A.cpu().numpy().astype(np.complex128)
        env = np.einsum("ab,apx,bpy->xy", env, A, A.conj())
    return env.reshape(()).real - 1


def run(device):
    psi0 = quimb_torch.MPS_neel_state(L, dtype=torch.float32, device=device)
    tebd = quimb_torch.TEBD(psi0, quimb_torch.ham_1d_heis(L),
                            split_opts={"max_bond": CHI, "cutoff": 1e-10})
    entropies, norms = [], []
    for k in range(1, STEPS + 1):
        tebd.update_to(k * DT, dt=DT)
        entropies.append(tebd.entropy(L // 2))
        if k % 2 == 0:
            norms.append(_norm_error(tebd))
    return np.asarray(entropies), tebd.trunc_err, norms


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None)
    device = parser.parse_args().device
    ref = json.loads(Path("benchref/REFBASE.json").read_text())
    ref = np.asarray(ref["tebd_L64_chi64"]["entropies"])
    mask_absorb = decomp._truncate_mask_absorb
    for name in ("float32", "float64"):
        decomp._truncate_mask_absorb = (mask_absorb if name == "float32"
                                        else _float64_mask(mask_absorb))
        entropies, trunc_err, norms = run(device)
        print(f"mask summed in {name}: entropies max "
              f"{np.abs(entropies - ref).max():.3e} from REFBASE, trunc_err "
              f"{trunc_err:.6f}, |<psi|psi> - 1| at steps 2, 4, ..: "
              + ", ".join(f"{n:+.2e}" for n in norms), flush=True)
    decomp._truncate_mask_absorb = mask_absorb


if __name__ == "__main__":
    main()
