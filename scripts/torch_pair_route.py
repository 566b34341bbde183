"""Time the two routes of a pairwise contraction step on one CUDA GPU.

``quimb_torch.ops.contraction`` runs every pairwise step as permute,
reshape and one batched ``matmul`` (``_pair_contract``). The other route
is one ``torch.einsum`` in sublist form with the step's labels renumbered
from 0, which takes at most 52 distinct labels. This script runs the
networks of ``chip_smoke.py``'s tensor-network phase through both, on a
random left-canonical L=128, chi=256 float64 MPS and the Heisenberg MPO
(bond 5):

- <psi|psi> (256 tensors) by the ``"auto"`` path;
- <psi|H|psi> (384 tensors) by ``contract_cumulative`` over I0..I127;
- <psi|H|psi> by the ``"greedy"`` path (2.06e13 flops).

Each contraction is timed on a synchronised host clock, a warm call then
the median of 3, in the order matmul, einsum, einsum, matmul; the two
routes' values must agree to 1e-12 relative, and <psi|psi> to 1. Run from the root of the
repository::

    python3 scripts/torch_pair_route.py
"""

import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import quimb_torch  # noqa: E402
from quimb_torch.ops import contraction as C  # noqa: E402

L, CHI = 128, 256
DEVICE = "cuda"
AGREE_TOL = 1e-12
MATMUL = C._pair_contract


def einsum_pair(a, la, b, lb, lo):
    """One pairwise step as one sublist ``torch.einsum``, its labels
    renumbered from 0 (at most 52 of them)."""
    (la, lb, lo), n = C._relabel(la, lb, lo)
    if n > C.MAX_EINSUM_LABELS:
        raise ValueError(f"{n} labels: beyond torch's sublist einsum")
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return torch.einsum(a, la, b, lb, lo)


ROUTES = {"matmul": MATMUL, "einsum": einsum_pair}


def left_canonical_mps(seed=7):
    """A random L-site MPS with bonds ``min(2^min(i, L-i), CHI)``, each
    site an isometry (the Q of a QR), so that <psi|psi> = 1."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    As = []
    for i in range(L):
        chil = min(CHI, 2 ** i, 2 ** (L - i))
        chir = min(CHI, 2 ** (i + 1), 2 ** (L - i - 1))
        x = torch.randn(chil * 2, chir, generator=gen, dtype=torch.float64,
                        device=DEVICE)
        As.append(torch.linalg.qr(x).Q.reshape(chil, 2, chir))
    return As


def networks():
    As = left_canonical_mps()
    Ws = quimb_torch.MPO_ham_heis(L, dtype=torch.float64, device=DEVICE)
    Tensor, TensorNetwork = quimb_torch.Tensor, quimb_torch.TensorNetwork
    ket = TensorNetwork([
        Tensor(A, inds=(f"k{i}", f"p{i}", f"k{i + 1}"),
               tags={f"I{i}", "KET"}) for i, A in enumerate(As)])
    ham = TensorNetwork([
        Tensor(W, inds=(f"h{i}", f"h{i + 1}", f"q{i}", f"p{i}"),
               tags={f"I{i}", "HAM"}) for i, W in enumerate(Ws)])
    bra = ket.conj(mangle_inner=True).reindex(
        {f"p{i}": f"q{i}" for i in range(L)})
    norm_tn = bra.reindex({f"q{i}": f"p{i}" for i in range(L)}) & ket
    return norm_tn, bra & ham & ket


def timed(fn, reps=3):
    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(out.data.reshape(())), statistics.median(times)


def main():
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: a CUDA GPU is needed")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    norm_tn, energy_tn = networks()
    sites = [f"I{i}" for i in range(L)]
    cases = {
        "<psi|psi> auto": lambda: norm_tn.contract(all, optimize="auto"),
        "<psi|H|psi> contract_cumulative":
            lambda: energy_tn.contract_cumulative(sites),
        "<psi|H|psi> greedy": lambda: energy_tn.contract(
            all, output_inds=(), optimize="greedy"),
    }
    rows = []
    for case, fn in cases.items():
        fn()  # the path search, outside the timed calls
        res = {}
        for route in ("matmul", "einsum", "einsum", "matmul"):
            C._pair_contract = ROUTES[route]
            try:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                value, secs = timed(fn)
                peak = torch.cuda.max_memory_allocated()
            finally:
                C._pair_contract = MATMUL
            res.setdefault(route, []).append((value, secs, peak))
            print(f"{case}, {route}: {secs:.6f} s warm (median of 3), "
                  f"value {value:.15e}, peak {peak / 1e9:.3f} GB",
                  flush=True)
        vm, ve = res["matmul"][0][0], res["einsum"][0][0]
        rel = abs(vm - ve) / abs(ve)
        print(f"{case}: routes agree to {rel:.3e} (bound {AGREE_TOL:.0e})",
              flush=True)
        if not rel < AGREE_TOL:
            raise AssertionError(f"{case}: the routes disagree")
        if case.startswith("<psi|psi>") and not abs(vm - 1) < AGREE_TOL:
            raise AssertionError(f"<psi|psi> = {vm!r}, not 1")
        rows.append({
            "case": case,
            "matmul_s": [s for _, s, _ in res["matmul"]],
            "einsum_s": [s for _, s, _ in res["einsum"]],
            "matmul_peak_gb": [p / 1e9 for _, _, p in res["matmul"]],
            "einsum_peak_gb": [p / 1e9 for _, _, p in res["einsum"]],
            "relative_difference": rel,
        })
    print(json.dumps({"pair_routes": rows}))


if __name__ == "__main__":
    main()
