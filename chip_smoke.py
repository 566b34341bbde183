"""Smoke run of quimb_torch's main path on one CUDA GPU.

Run from the root of the repository, on a machine with an NVIDIA Hopper
GPU and the CUDA toolkit::

    python3 chip_smoke.py

It drives the 1D ground-state engine of the spin-1/2 Heisenberg chain at
L=128, chi=256 through the package's entry points (``MPO_ham_heis``,
``MPS_rand_state``, ``DMRG2``, ``DMRG1``, ``ParallelDMRG``): DMRG2 on a
float32 state, with every effective-Hamiltonian matvec in the
hand-written 3xTF32 sandwich kernel and every bond split by the card's
default split (``svd:sub``, run as ``svd:sub0`` at cutoff 0), then
ParallelDMRG from that state; DMRG2 on a float64 state, with every matvec
in the hand-written FP64 tensor-core (DMMA) kernel, then DMRG1 from that
state. Then the TEBD quench, the exact 20-qubit core and the 53-qubit
circuit. Its phases, each fatal on failure:

1. the device: a CUDA GPU is required; its name and power limit are
   printed;
2. the build of ``quimb_torch/csrc`` with nvcc, timed; ptxas must report
   no spills, and the float64 kernel's SASS must hold DMMA instructions;
3. the kernels against their plain einsum (in float64) on the card, in
   float32 (3xTF32) and float64 (DMMA) at the paths' shapes; two
   applications of one prepared operand set, and a one-shot call, must
   agree bitwise; for each dtype, CUDA-event times of the matvec and the
   plain einsum at the north-star shape, in the order plain, kernel,
   kernel, plain, the prepare step's time and each launch's device time
   (``torch.profiler``);
4. the float32 DMRG2 path: right sweeps at max_bond 64, 128, 256, 256,
   256, then one left sweep; each sweep must launch the float32 kernel
   at least ncv * restarts * (L - 1) times and the float64 one never;
   the final state's energy, evaluated in float64 on the host, must lie
   within a relative 2e-5 of E_REF;
5. where one bulk bond's time goes, phase by phase, the path's split and
   ``gesvd``'s masked SVD both timed;
6. the split methods at that bond's updated theta, with the center of
   the state at the bond: ``svd`` (cutoff 0 and 1e-10), ``svd:eig``,
   ``svd:sub`` (cutoff 1e-10) and ``svd:sub0``, each timed, with its
   residual and the orthogonality of its isometric factor; the factors
   must be finite and the isometric one orthogonal to 1e-4 (float32) or
   1e-10 (float64); in float64 the ``svd:eig`` residual must lie within
   1 % of ``gesvd``'s, and a subspace method's within twice ``gesvd``'s
   at the same cutoff (or within ``gesvd``'s plus 1.5e-8, the float64
   floor of a gram-matrix method);
7. the ParallelDMRG path from the float32 DMRG2 state, with bench.py's
   settings (S=2 segments, ncv=8, 3 inner passes): two outer sweeps,
   each launching the float32 kernel at least (2 * 3 + 1) * S' * 63 * 8
   times (S' its count of segments: 2, then 1 at the offset) and the
   float64 one never; the final state's host energy within a relative
   2e-5 of E_REF;
8. the float64 DMRG2 path: the schedule of phase 4 on a float64 state;
   each sweep must launch the float64 kernel at least ncv * restarts *
   (L - 1) times and the float32 one never; the host energy must lie
   within a relative 1e-6 of E_REF; then phases 5 and 6 on one of its
   bulk bonds;
9. the DMRG1 path from the float64 DMRG2 state: one right and one left
   sweep at max_bond 256, each launching the float64 kernel once per
   Lanczos vector at every site (8, and 4 at each chain end, whose
   one-site space has dimension 4) and the float32 one never; the host
   energy within a relative 1e-6 of E_REF, and no more than 1e-9
   relative above the DMRG2 state's;
10. the TEBD real-time quench of benchref/measure_tpu_tebd.py, once in
   complex128 (quimb's dtype) and once in complex64 (the TPU bench's):
   the Heisenberg chain at L=64 from the Néel state, max_bond 64, cutoff
   1e-10, 20 fourth-order steps of dt 0.05, through entry points called
   with no device (so on the GPU). Each step is timed with a synchronised
   host clock after a warm-up of 2 dt on a copy. Every stack must be on
   the GPU, finite and in the dtype asked for; the 20 half-chain
   entropies within 2e-4 of the reference curve in benchref/REFBASE.json
   (both dtypes); ``err`` within 1e-9 relative of the reference's; the
   final state's norm, on the host in float64, within 1e-8 or 1e-4 of 1;
   the quench's own SVD route (the checked complex128 ``gesvdj``, a
   complex64 batch taken to complex128) orthogonal on one parity sweep's
   batch; and no sandwich kernel launched. Printed, not gated: the
   distance to quimb_tpu's own complex128 CPU curve, the discarded
   weight, the device's busy share over one step (``torch.profiler``),
   the SVD drivers of cuSOLVER on that (32, 128, 128) batch, time and
   orthogonality of each, and the batches ``gesvdj`` failed on and
   ``gesvd`` redid;
11. the exact 20-qubit core of benchref/measure_tpu_exact20.py (20 1.0 4)
   through entry points called with no device: ``ham_heis(20,
   sparse=True)``, ``groundenergy`` twice (cold, warm) and
   ``groundstate``, then ``Evolution`` of the state "0101..." by
   ``method="expm"`` to t = 0.25, 0.5, 0.75, 1 after a warm-up on a copy,
   each call on a synchronised host clock. Gated: every operator and
   state tensor on the GPU, float64 for H and the ground state, complex128
   for the evolved state; the energy within 1e-10 relative of REFBASE's;
   each <Z_0>, from |psi|^2 on the card, within 1e-9 of REFBASE's; the
   final norm within 1e-10 of 1; the ELL ``SparseHam`` matvec within
   1e-12 relative of the ``LocalTermsHam`` one on a seeded vector.
   Printed: the matvec of each operator in float64 and complex128 (CUDA
   events) against the bound of reading x and writing H x once, the bytes
   the per-term loop moves, each term's time alone, the matvecs and
   Lanczos restarts of each call, and the busy share over one warm
   ``groundenergy`` and one expm update;
13. the 53-qubit depth-12 circuit of benchref/circuit53.py through
   ``Circuit.from_openqasm2_str`` with no device, once in complex128
   (quimb's dtype) and once in complex64 (the TPU bench's): ``amp0`` and
   the four amplitudes of benchref/measure_tpu_circuit53.py, each cold
   then warm on a synchronised host clock, the warm call split into the
   host rewrite (``rehearse=True``) and the contraction alone on the card.
   Gated: the circuit on the GPU; every pairwise step of an amplitude on
   CUDA tensors; each amplitude within 1e-9 (complex128) or 1e-3
   (complex64) relative of REFBASE's; ``sample(20, seed=42)`` in
   complex128 equal to quimb_tpu's strings, its steps on CUDA tensors;
   no sandwich kernel launched. Printed: each expression's flops, width
   and steps, ``amp0`` by ``backend="numpy"``, the busy share over one
   warm ``amp0`` and over ``sample(2)`` of a fresh circuit, and the
   sampler's groups by route.

The line before the last is the kernels' JSON summary, one entry per
kernel with its launches on its paths (DMRG2 and ParallelDMRG for
float32, DMRG2 and DMRG1 for float64; TEBD runs no hand-written kernel),
its time against the plain einsum (the one library call that computes
the same product) and its bound. The exact core runs no hand-written
kernel: its matvec is plain PyTorch, measured in phase 11; nor does the
circuit: quimb_tpu's circuit path has no Pallas kernel, and its pairwise
contractions run as batched ``matmul`` on the card. The last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import functools
import json
import re
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

import quimb_torch
from quimb_torch import core
from quimb_torch.ops import _build
from quimb_torch.ops import cuda_kernels as ck
from quimb_torch.ops import decomp
from quimb_torch.ops.backend import to_host
from quimb_torch.tensor.tn1d import dmrg as D
from quimb_torch.tensor.tn1d.dmrg_parallel import ParallelDMRG

L, CHI, P0_BOND, SEED = 128, 256, 32, 42
R_SCHEDULE = (64, 128, 256, 256, 256)
# converged float64 DMRG2 energy of this chain (bench.py:392) and the
# bench's acceptance bounds on the relative error for a float32 and a
# float64 state (bench.py:402)
E_REF = -56.535467821834
E_REL_TOL = {torch.float32: 2e-5, torch.float64: 1e-6}
# (w, M, K1, K2, N): the bulk bond at chi=256, the 1-site (DMRG1) bond,
# bonds next to a chain end (the end itself has M = K1 = 2), a ragged
# shape that leaves partial tiles on every edge, and 1 x 1 bonds
CHECK_SHAPES = ((5, 512, 512, 512, 512), (5, 512, 512, 256, 256),
                (5, 4, 4, 512, 512), (5, 2, 2, 512, 512),
                (5, 130, 66, 98, 34), (1, 1, 1, 1, 1))
# relative Frobenius error against float64: accumulation over depths of
# 512 and 5 * 512, in 3xTF32 for float32 and on the FP64 tensor cores for
# float64
KERNEL_TOLS = {torch.float32: 1e-5, torch.float64: 1e-12}
KERNEL_NAME = {torch.float32: "sandwich_tf32", torch.float64: "sandwich_f64"}
KERNEL_SOURCE = {torch.float32: "quimb_torch/csrc/sandwich_tf32.cu",
                 torch.float64: "quimb_torch/csrc/sandwich_f64.cu"}
KERNEL_KIND = {torch.float32: "3xTF32", torch.float64: "FP64 DMMA"}
# the card's peak rates for each kernel's work (NVIDIA's data sheet, H100
# SXM, 700 W): 3xTF32 does three TF32 products per float32 product, so
# 495 / 3 TFLOP/s of float32 work; float64 on the FP64 tensor cores
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.float64: 67e12}
PEAK_BYTES = 3.35e12


def check_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)


def build_kernels():
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s ({lib})",
          flush=True)
    log = (lib.parent / "build.log").read_text()
    print(log, flush=True)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                        r"loads", log)
    if not spills or any(n != "0" for pair in spills for n in pair):
        raise AssertionError("ptxas reports spills (or no spill report)")
    # the float64 kernel's products must run on the FP64 tensor cores
    # (DMMA), not on the FMA pipes (DFMA)
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    dmma = re.findall(r"\bDMMA\.\S+", sass)
    dfma = re.findall(r"\bDFMA\b", sass)
    print(f"SASS: {len(dmma)} DMMA instructions {sorted(set(dmma))}, "
          f"{len(dfma)} DFMA", flush=True)
    if not dmma:
        raise AssertionError("the float64 kernel's SASS holds no DMMA")


def _cuda(x, dtype):
    return torch.as_tensor(x, dtype=dtype, device="cuda")


def _event_ms(fn, args, reps=50):
    for _ in range(5):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _rel_err(got, ref):
    return (torch.linalg.norm(got.double() - ref)
            / torch.linalg.norm(ref)).item()


def check_kernel():
    """Kernels vs plain version at every check shape, with bitwise
    repeatability; returns ({dtype: max_abs_err at the north-star shape},
    its host operands)."""
    rng = np.random.default_rng(SEED)
    max_abs_err, north = {}, None
    for shape in CHECK_SHAPES:
        w, M, K1, K2, N = shape
        host = (rng.standard_normal((w, M, K1)),
                rng.standard_normal((K1, K2)),
                rng.standard_normal((w, K2, N)))
        ref = ck.sandwich_matvec_reference(
            *(_cuda(x, torch.float64) for x in host)
        )
        for dtype, tol in KERNEL_TOLS.items():
            a, theta, b = (_cuda(x, dtype) for x in host)
            before = ck.LAUNCHES[KERNEL_NAME[dtype]]
            heff = ck.resolve_sandwich("cuda", dtype)(a, b)
            got, again = heff(theta), heff(theta)
            one_shot = ck.sandwich_matvec(a, theta, b)
            torch.cuda.synchronize()
            if ck.LAUNCHES[KERNEL_NAME[dtype]] != before + 3:
                raise AssertionError("the kernel's launch count is off")
            rel = _rel_err(got, ref)
            same = torch.equal(got, again) and torch.equal(got, one_shot)
            print(f"kernel {dtype} {shape}: relative error {rel:.3e} "
                  f"(tolerance {tol:.0e}), bitwise repeatable {same}",
                  flush=True)
            if not rel <= tol:
                raise AssertionError(f"sandwich kernel disagrees at "
                                     f"{shape} {dtype}: {rel:.3e}")
            if not same:
                raise AssertionError(f"sandwich kernel not repeatable at "
                                     f"{shape} {dtype}")
            if shape == CHECK_SHAPES[0]:
                max_abs_err[dtype] = (got.double() - ref).abs().max().item()
                north = host
    return max_abs_err, north


# the launches of one matvec, by kernel name, demangled or not
TF32_LAUNCHES = (("split theta", ("split_transpose",)),
                 ("pass 1", ("gemm_3xtf32<true>", "gemm_3xtf32ILb1E")),
                 ("pass 2", ("gemm_3xtf32<false>", "gemm_3xtf32ILb0E")),
                 ("sum over x", ("sum_partials",)))
F64_LAUNCHES = (("pad theta", ("pad_transpose_f64",)),
                ("passes 1 and 2", ("gemm_dmma",)),
                ("sum over x", ("sum_partials_f64",)))
LAUNCH_STEPS = {torch.float32: TF32_LAUNCHES, torch.float64: F64_LAUNCHES}


def _launch_device_ms(heff, theta, steps, reps=20):
    """Device ms per matvec of each step of ``steps``, from
    torch.profiler; None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            heff(theta)
        torch.cuda.synchronize()
    events = prof.key_averages()
    times = {}
    for step, names in steps:
        total = sum(getattr(ev, "device_time_total", 0) or 0
                    for ev in events if any(n in ev.key for n in names))
        times[step] = total / 1e3 / reps if total > 0 else None
    return times


def time_kernel(host, dtype):
    """CUDA-event times at the north-star shape; returns (kernel ms,
    plain ms) of the matvec in ``dtype``."""
    a, theta, b = (_cuda(x, dtype) for x in host)
    heff = ck.prepare_sandwich(a, b)
    # plain, kernel, kernel, plain on the same operands
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        if name == "plain":
            times[name].append(_event_ms(ck.sandwich_matvec_reference,
                                         (a, theta, b)))
        else:
            times[name].append(_event_ms(heff, (theta,)))
    flop = sandwich_bound(dtype)[2]
    kernel_ms = statistics.mean(times["kernel"])
    plain_ms = statistics.mean(times["plain"])
    print(f"sandwich at {CHECK_SHAPES[0]} {dtype}: kernel (prepared, "
          f"{KERNEL_KIND[dtype]}) {times['kernel']} ms "
          f"({flop / kernel_ms / 1e9:.2f} TFLOP/s), plain einsum "
          f"{times['plain']} ms ({flop / plain_ms / 1e9:.2f} TFLOP/s)",
          flush=True)
    prep_ms = _event_ms(ck.prepare_sandwich, (a, b), reps=20)
    print(f"  prepare step, once per local solve: {prep_ms:.4f} ms",
          flush=True)
    steps = _launch_device_ms(heff, theta, LAUNCH_STEPS[dtype])
    for step, ms in steps.items():
        print(f"  {step}: " + ("device time not measured" if ms is None
                               else f"{ms:.4f} ms device time"),
              flush=True)
    if all(steps.values()):
        print(f"  all launches: {sum(steps.values()):.4f} ms device time "
              f"per matvec", flush=True)
    return kernel_ms, plain_ms


def sandwich_bound(dtype):
    """(ms, "bytes" or "operations", flop): the least time of one matvec
    at the north-star shape, the larger of its operands' and result's
    bytes over the memory rate and its products over the peak rate."""
    w, M, K1, K2, N = CHECK_SHAPES[0]
    flop = 2 * w * (M * K1 * K2 + M * K2 * N)
    nbytes = (w * M * K1 + K1 * K2 + w * K2 * N + M * N) * dtype.itemsize
    ops_ms = flop / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes"), flop


def host_f64_energy(As, Ws):
    """⟨ψ|H|ψ⟩/⟨ψ|ψ⟩ of the state in float64 numpy (bench.py:333-348)."""
    energy, norm = host_f64_sweep(As, Ws)
    return energy / norm


def host_f64_sweep(As, Ws):
    """(⟨ψ|H|ψ⟩, ⟨ψ|ψ⟩) of the state by the sweep of bench.py:333-348, in
    float64 numpy on the host."""
    env = np.ones((1, 1, 1))
    nrm = np.ones((1, 1))
    for A, W in zip(As, Ws):
        Ah = to_host(A).astype(np.float64)
        Wh = to_host(W).astype(np.float64)
        env = np.einsum("bwk,kdx->bwdx", env, Ah, optimize=True)
        env = np.einsum("bwdx,wyud->byux", env, Wh, optimize=True)
        env = np.einsum("byux,bua->ayx", env, Ah.conj(), optimize=True)
        nrm = np.einsum("bk,kdx->bdx", nrm, Ah, optimize=True)
        nrm = np.einsum("bdx,bda->ax", nrm, Ah.conj(), optimize=True)
    return float(env.reshape(())), float(nrm.reshape(()))


def run_main_path(dtype):
    """The DMRG2 main path on a state of ``dtype``; returns (dmrg, its
    kernel's launches)."""
    H = quimb_torch.MPO_ham_heis(L, dtype=dtype, device="cuda")
    p0 = quimb_torch.MPS_rand_state(L, P0_BOND, seed=SEED, dtype=dtype,
                                    device="cuda")
    dmrg = quimb_torch.DMRG2(H, bond_dims=CHI, cutoffs=0.0, p0=p0)
    opts = dmrg.opts
    _check_default_split(dmrg, "DMRG2")
    min_launches = (max(2 * opts["local_eig_ncv"],
                        opts["local_eig_ncv_floor"])
                    * opts["local_eig_restarts"] * (L - 1))
    sweeps = [("R", mb) for mb in R_SCHEDULE] + [("L", CHI)]
    kernel = KERNEL_NAME[dtype]

    _reset_launches()
    t_path = time.perf_counter()
    for direction, max_bond in sweeps:
        before = dict(ck.LAUNCHES)
        t0 = time.perf_counter()
        en = dmrg.sweep(direction, max_bond=max_bond, cutoff=0.0,
                        canonize=direction == "R")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        dmrg.energies.append(en)
        n = _sweep_launches(kernel, before, min_launches, "DMRG2 sweep")
        print(f"{dtype} sweep {direction} max_bond={max_bond}: {dt:.3f} s, "
              f"energy {en:.10f}, sandwich launches {n}", flush=True)
    launches = ck.LAUNCHES[kernel]
    print(f"{dtype} main path: {time.perf_counter() - t_path:.3f} s, "
          f"sandwich launches {dict(ck.LAUNCHES)}", flush=True)

    for A in dmrg.state:
        if not (A.shape[0] <= CHI and A.shape[2] <= CHI and A.dtype == dtype
                and bool(torch.isfinite(A).all())):
            raise AssertionError(f"bad site tensor {tuple(A.shape)}")
    _check_energy(dmrg.state, dmrg._W, dtype,
                  f"{dtype} DMRG2 state (last sweep energy "
                  f"{dmrg.energies[-1]:.10f})")
    return dmrg, launches


def _check_default_split(dmrg, what):
    """The engine on the card must split by quimb_tpu's accelerator
    default, "svd:sub" ("svd:sub0" at cutoff 0)."""
    method = dmrg.opts["bond_compress_method"]
    print(f"{what} bond_compress_method {method!r}, at cutoff 0 "
          f"{dmrg._split_method(0.0)!r}", flush=True)
    if method != "svd:sub":
        raise AssertionError(f"{what} on the card splits by {method!r}")


def _host_ms(fn, reps=5):
    """Median wall ms of ``fn()`` bracketed by device synchronisation."""
    out = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out[1:])


def _mixed_canonical_bond(dmrg, i):
    """The environments and two-site tensor of bond (i, i + 1) with the
    orthogonality center there, as a right sweep meets it: the state
    after a left sweep is right-canonical, and QR moves its center from
    site 0 to site i. Returns (lenv, renv, theta0)."""
    As = list(dmrg.state)
    for j in range(i):
        l, p, r = As[j].shape
        Q, _, Rf = decomp.qr_stabilized(As[j].reshape(l * p, r))
        As[j] = Q.reshape(l, p, Q.shape[-1])
        As[j + 1] = torch.einsum("ck,kpr->cpr", Rf, As[j + 1])
    lenv = dmrg._ones_env()
    for j in range(i):
        lenv = D._env_step_right(lenv, torch.conj(As[j]), dmrg._W[j], As[j])
    renv = dmrg._ones_env()
    for j in range(L - 1, i + 1, -1):
        renv = D._env_step_left(renv, torch.conj(As[j]), dmrg._W[j], As[j])
    return lenv, renv, torch.einsum("kpc,cqr->kpqr", As[i], As[i + 1])


def bond_breakdown(dmrg):
    """Wall time of each phase of one bulk bond update at chi=256;
    returns the updated two-site tensor."""
    i = L // 2
    lenv, renv, theta0 = _mixed_canonical_bond(dmrg, i)
    W1, W2 = dmrg._W[i], dmrg._W[i + 1]
    kw = dmrg._solve_opts()
    _, theta = D._local_solve_2site(lenv, W1, W2, renv, theta0, **kw)
    method = dmrg._split_method(0.0)
    N1, _, _ = D._split_2site(theta, CHI, 0.0, "right", method=method)
    A, B = D._sandwich_operands(lenv, W1, W2, renv)
    th = theta.reshape(A.shape[2], B.shape[1])
    mat = theta.reshape(A.shape[1], B.shape[2])
    T = torch.diag(torch.linspace(-1, 1, kw["ncv"], device=theta.device))
    heff = ck.prepare_sandwich(A, B)
    phases = {
        "local solve (operands + prepare + Lanczos + eigh)": lambda: (
            D._local_solve_2site(lenv, W1, W2, renv, theta0, **kw)),
        "  sandwich operands": lambda: D._sandwich_operands(
            lenv, W1, W2, renv),
        "  sandwich prepare (once per solve)": lambda: ck.prepare_sandwich(
            A, B),
        f"  one sandwich matvec ({kw['ncv']} per solve)": lambda: heff(th),
        f"  eigh {kw['ncv']}x{kw['ncv']}": lambda: torch.linalg.eigh(T),
        f"split (the path's, {method})": lambda: D._split_2site(
            theta, CHI, 0.0, "right", method=method),
        "split (masked SVD, svd)": lambda: D._split_2site(theta, CHI, 0.0,
                                                          "right"),
        f"  torch.linalg.svd {tuple(mat.shape)}, gesvd": lambda: (
            torch.linalg.svd(mat, full_matrices=False, driver="gesvd")),
        "env step": lambda: D._env_step_right(lenv, torch.conj(N1), W1,
                                              N1),
    }
    print(f"bulk bond {i} (theta {tuple(theta0.shape)}, {theta0.dtype}), "
          f"median wall ms:", flush=True)
    for name, fn in phases.items():
        print(f"  {name}: {_host_ms(fn):.3f}", flush=True)
    return theta


# (method, cutoff) of each split; "svd" at both cutoffs is the reference
# of the methods at the same cutoff ("svd:sub0" has none: it keeps max_bond)
SPLITS = (("svd", 0.0), ("svd", 1e-10), ("svd:eig", 0.0),
          ("svd:sub", 1e-10), ("svd:sub0", 0.0))
# ||U^T U - I||_2 (the spectral norm: how far the kept columns are from
# an isometry, whatever their count) of the isometric factor
ORTHO_TOLS = {torch.float32: 1e-4, torch.float64: 1e-10}


def check_splits(theta):
    """Each split method at one updated bulk theta, absorb "right" (A1
    isometric): median wall ms, relative residual ||theta - A1 A2|| /
    ||theta|| and orthogonality of A1, with the gates of phase 6."""
    dtype = theta.dtype
    th = theta.double()
    res = {}
    print(f"splits of theta {tuple(theta.shape)} {dtype} to max_bond {CHI}, "
          f"absorb right:", flush=True)
    for method, cutoff in SPLITS:
        split = functools.partial(D._split_2site, theta, CHI, cutoff, "right",
                                  method=method)
        A1, A2, rank = split()
        ms = _host_ms(split)
        r = int(rank)
        finite = bool(torch.isfinite(A1).all()) and bool(
            torch.isfinite(A2).all())
        prod = torch.einsum("kpc,cqr->kpqr", A1.double(), A2.double())
        res[method, cutoff] = (torch.linalg.norm(th - prod)
                               / torch.linalg.norm(th)).item()
        # the kept columns: the mask zeroes the others
        U = A1.reshape(-1, A1.shape[-1]).double()
        nonzero = torch.linalg.norm(U, dim=0) > 0
        U = U[:, nonzero]
        kept = U.shape[1]
        E = U.T @ U - torch.eye(kept, dtype=U.dtype, device=U.device)
        orth = torch.linalg.matrix_norm(E, 2).item()
        print(f"  {method} (cutoff {cutoff:g}): {ms:.3f} ms, rank {r}, "
              f"last kept column {int(torch.nonzero(nonzero).max()) + 1}, "
              f"residual {res[method, cutoff]:.6e}, ||U^T U - I|| "
              f"{orth:.3e} (2-norm), {torch.linalg.norm(E).item():.3e} "
              f"(Frobenius), finite {finite}", flush=True)
        if kept != r:
            raise AssertionError(f"split {method}: rank {r} but {kept} "
                                 f"nonzero columns")
        if not finite:
            raise AssertionError(f"split {method}: factors not finite")
        if not orth <= ORTHO_TOLS[dtype]:
            raise AssertionError(f"split {method}: isometric factor off by "
                                 f"{orth:.3e}")
    if dtype != torch.float64:
        return
    # float64 only: the float32 gram matrix loses the values below
    # sqrt(eps) s_0, a property of the method (printed, not gated). In
    # float64 that floor is sqrt(eps) = 1.5e-8 relative: a bound never
    # asks a gram-matrix method for less than gesvd's residual plus it
    floor = torch.finfo(torch.float64).eps ** 0.5

    def bound(factor, cutoff):
        return max(factor * res["svd", cutoff], res["svd", cutoff] + floor)

    if not res["svd:eig", 0.0] <= bound(1.01, 0.0):
        raise AssertionError("svd:eig's residual exceeds gesvd's by > 1 %")
    for key in (("svd:sub", 1e-10), ("svd:sub0", 0.0)):
        if not res[key] <= bound(2, key[1]):
            raise AssertionError(f"{key[0]}'s residual exceeds twice "
                                 f"gesvd's")


def _reset_launches():
    torch.cuda.synchronize()
    for name in ck.LAUNCHES:
        ck.LAUNCHES[name] = 0


def _sweep_launches(kernel, before, at_least, what):
    """The launches since ``before``, by kernel; fails unless ``kernel``
    has at least ``at_least`` and no other kernel has any."""
    n = {k: ck.LAUNCHES[k] - before[k] for k in before}
    if n[kernel] < at_least or sum(n.values()) != n[kernel]:
        raise AssertionError(f"{what} launched the kernels {n}; {kernel} "
                             f"fewer than {at_least} times, or another "
                             f"kernel")
    return n


def _check_energy(state, Ws, dtype, what):
    """The host float64 energy of ``state`` against E_REF."""
    t0 = time.perf_counter()
    e64 = host_f64_energy(state, Ws)
    rel = abs(e64 - E_REF) / abs(E_REF)
    tol = E_REL_TOL[dtype]
    print(f"{what}: float64 host energy {e64:.10f} "
          f"({time.perf_counter() - t0:.1f} s): delta {e64 - E_REF:.3e}, "
          f"relative {rel:.3e} (bound {tol:.0e})", flush=True)
    if not rel < tol:
        raise AssertionError(f"{what}: energy {e64} misses E_REF {E_REF}")
    return e64


PAR_SEGMENTS, PAR_NCV, PAR_INNER, PAR_SWEEPS = 2, 8, 3, 2


def run_parallel_path(dmrg2):
    """ParallelDMRG from the float32 DMRG2 state (bench.py:239-245);
    returns its float32 kernel launches."""
    Ws = dmrg2._W
    pd = ParallelDMRG(dmrg2.state, Ws, max_bond=CHI, n_segments=PAR_SEGMENTS,
                      ncv=PAR_NCV, inner_passes=PAR_INNER)
    _reset_launches()
    t_path = time.perf_counter()
    for _ in range(PAR_SWEEPS):
        # the segments of this outer sweep: the offset alternates by half
        # a segment (ParallelDMRG.sweep)
        off = (pd.m // 2) * (pd._phase % 2)
        n_seg = len(range(off, pd.L - pd.m + 1, pd.m))
        at_least = (2 * PAR_INNER + 1) * n_seg * (pd.m - 1) * PAR_NCV
        before = dict(ck.LAUNCHES)
        t0 = time.perf_counter()
        en = pd.sweep()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = _sweep_launches("sandwich_tf32", before, at_least,
                            "parallel outer sweep")
        print(f"ParallelDMRG outer sweep (offset {off}, {n_seg} segments): "
              f"{dt:.3f} s, energy {en:.10f}, sandwich launches {n} "
              f"(at least {at_least})", flush=True)
    launches = ck.LAUNCHES["sandwich_tf32"]
    print(f"ParallelDMRG path: {time.perf_counter() - t_path:.3f} s, "
          f"sandwich launches {dict(ck.LAUNCHES)}", flush=True)
    state = pd.get_state()
    for A in state:
        if not bool(torch.isfinite(A).all()):
            raise AssertionError(f"bad site tensor {tuple(A.shape)}")
    _check_energy(state, Ws, torch.float32, "ParallelDMRG float32 state")
    return launches


def run_dmrg1_path(dmrg2):
    """DMRG1 from the float64 DMRG2 state; returns its float64 kernel
    launches."""
    Ws = dmrg2._W
    e2 = host_f64_energy(dmrg2.state, Ws)
    dmrg = quimb_torch.DMRG1(Ws, bond_dims=CHI, cutoffs=0.0, p0=dmrg2.state)
    _check_default_split(dmrg, "DMRG1")
    opts = dmrg.opts
    ncv = max(2 * opts["local_eig_ncv"], opts["local_eig_ncv_floor"])
    _reset_launches()
    t_path = time.perf_counter()
    for direction in "RL":
        # one launch per Lanczos vector; the basis stops at the dimension
        # of the one-site space, 4 at a chain end
        at_least = opts["local_eig_restarts"] * sum(
            min(ncv, A.numel()) for A in dmrg.state)
        before = dict(ck.LAUNCHES)
        t0 = time.perf_counter()
        en = dmrg.sweep(direction, max_bond=CHI, cutoff=0.0,
                        canonize=direction == "R")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = _sweep_launches("sandwich_f64", before, at_least, "DMRG1 sweep")
        print(f"DMRG1 sweep {direction} max_bond={CHI}: {dt:.3f} s, energy "
              f"{en:.10f}, sandwich launches {n} (at least {at_least})",
              flush=True)
    launches = ck.LAUNCHES["sandwich_f64"]
    print(f"DMRG1 path: {time.perf_counter() - t_path:.3f} s, sandwich "
          f"launches {dict(ck.LAUNCHES)}", flush=True)
    e1 = _check_energy(dmrg.state, Ws, torch.float64, "DMRG1 float64 state")
    rise = (e1 - e2) / abs(e2)
    print(f"DMRG1 energy against the DMRG2 state's {e2:.10f}: relative "
          f"change {rise:.3e} (rise bound 1e-9)", flush=True)
    if not rise <= 1e-9:
        raise AssertionError("DMRG1 raised the DMRG2 state's energy")
    return launches


# -- phase 12: the tensor-network layer on the north-star state --------------

# bounds, relative: the <psi|psi> contraction against the host sweep (two
# float64 sums over 256 tensors in different orders); each route's energy
# ratio against the host sweep's; the pair's product after the compression
# against the rank-128 truncation of the fused pair by torch.linalg.svd;
# and the ket's norm across the canonisation (a QR and its product)
TN_NORM_TOL, TN_ENERGY_TOL, TN_SPLIT_TOL, TN_CANON_TOL = (1e-12, 1e-10,
                                                          1e-10, 1e-12)
TN_BOND, TN_MAX_BOND = 64, 128


def _tn_scalar(x):
    """A full contraction's value as a Python float: a scalar tensor, or a
    tensor whose remaining indices (the MPO's size-1 ends) have size 1."""
    data = x.data if isinstance(x, quimb_torch.Tensor) else x
    return float(data.reshape(()))


def _tn_networks(As, Ws):
    """The ket, operator and bra networks of <psi|H|psi>, built through
    the public API as make_overlap builds them: the bra is the ket's
    conjugate with its inner indices mangled and its physical indices
    renamed p -> q, the operator's upper indices."""
    Tensor, TensorNetwork = quimb_torch.Tensor, quimb_torch.TensorNetwork
    ket = TensorNetwork([
        Tensor(A, inds=(f"k{i}", f"p{i}", f"k{i + 1}"),
               tags={f"I{i}", "KET"}) for i, A in enumerate(As)])
    ham = TensorNetwork([
        Tensor(W, inds=(f"h{i}", f"h{i + 1}", f"q{i}", f"p{i}"),
               tags={f"I{i}", "HAM"}) for i, W in enumerate(Ws)])
    bra = ket.conj(mangle_inner=True).reindex(
        {f"p{i}": f"q{i}" for i in range(len(As))})
    bra.retag_({"KET": "BRA"})
    return ket, ham, bra


def _tn_search(tn, optimize, output_inds=None):
    """The contraction expression of ``tn`` and the host seconds of its
    path search (a fresh search, not a cache hit)."""
    from quimb_torch.ops import contraction as C

    C._EXPR_CACHE.clear()
    t0 = time.perf_counter()
    info = tn.contraction_info(output_inds, optimize)
    return info, time.perf_counter() - t0


def _tn_timed(fn, reps=3):
    """(result, seconds): a warm call, then the median of ``reps`` calls
    on a synchronised host clock."""
    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times)


def _tn_counted(fn):
    """(flops, width) of the contractions ``fn`` runs: the sum of each
    call's path cost and the largest width, from the expression of every
    array_contract call, without changing what runs."""
    from quimb_torch.ops import contraction as C
    from quimb_torch.tensor import core as tcore

    flops, width = [0.0], [0.0]
    plain = tcore.array_contract

    def counted(arrays, inputs, output=None, **kwargs):
        out = C.find_output_inds(inputs) if output is None else output
        expr = C.array_contract_expression(
            inputs, out, shapes=[a.shape for a in arrays],
            optimize=kwargs.get("optimize"))
        flops[0] += expr.flops
        width[0] = max(width[0], expr.width)
        return plain(arrays, inputs, output, **kwargs)

    tcore.array_contract = counted
    try:
        fn()
    finally:
        tcore.array_contract = plain
    return flops[0], width[0]


def _tn_report(what, info, search_s, secs):
    print(f"{what}: path search {search_s:.3f} s, flops {info.flops:.4e}, "
          f"width {info.width:.2f}, {secs:.4f} s warm (median of 3), "
          f"{info.flops / secs / 1e12:.3f} TFLOP/s", flush=True)


def run_tn_layer(dmrg):
    """The tensor-network object layer on the float64 DMRG2 state: the
    norm and energy networks of the L=128, chi=256 state contracted by
    three routes, and a canonisation and compression at bond 64."""
    from quimb_torch.ops.native import native_available

    t_phase = time.perf_counter()
    As = list(dmrg.state)
    Ws = quimb_torch.MPO_ham_heis(L, dtype=torch.float64, device="cuda")
    _reset_launches()
    before = dict(ck.LAUNCHES)
    ket, ham, bra = _tn_networks(As, Ws)
    for name, tn in (("ket", ket), ("operator", ham), ("bra", bra)):
        bad = [t for t in tn if not (t.data.is_cuda
                                     and t.dtype == torch.float64)]
        if bad:
            raise AssertionError(f"{name} tensor {bad[0]} is not float64 "
                                 f"on the card")
    print(f"networks: ket {ket.num_tensors} tensors, operator "
          f"{ham.num_tensors}, bra {bra.num_tensors}; all float64 on the "
          f"card", flush=True)
    if not native_available():
        raise AssertionError("the native path finder did not build/load")
    print("native path finder: loaded", flush=True)

    t0 = time.perf_counter()
    e_host, n_host = host_f64_sweep(As, Ws)
    print(f"host float64 sweep: <psi|H|psi> {e_host:.12f}, <psi|psi> "
          f"{n_host:.15f} ({time.perf_counter() - t0:.1f} s)", flush=True)

    # <psi|psi> by quimb_tpu's default path, "auto" (native random-greedy):
    # the bra with its physical indices back on the ket's
    norm_tn = bra.reindex({f"q{i}": f"p{i}" for i in range(L)}) & ket
    info, search = _tn_search(norm_tn, "auto")
    n_auto, secs = _tn_timed(lambda: norm_tn.contract(all, optimize="auto"))
    n_auto = _tn_scalar(n_auto)
    _tn_report("<psi|psi> by 'auto'", info, search, secs)
    rel = abs(n_auto - n_host) / abs(n_host)
    print(f"<psi|psi> {n_auto:.15f}, relative to the host sweep "
          f"{rel:.3e} (bound {TN_NORM_TOL:.0e})", flush=True)
    if not rel < TN_NORM_TOL:
        raise AssertionError("<psi|psi> misses the host sweep")

    # <psi|H|psi> / <psi|psi> by the site-by-site sweep
    energy_tn = bra & ham & ket
    sites = [f"I{i}" for i in range(L)]
    e_cum, secs = _tn_timed(lambda: energy_tn.contract_cumulative(sites))
    e_cum = _tn_scalar(e_cum)
    print(f"<psi|H|psi> by contract_cumulative over I0..I{L - 1}: "
          f"{secs:.4f} s warm (median of 3)", flush=True)
    busy, top, wall_us, count = _busy_share(
        lambda: energy_tn.contract_cumulative(sites))
    print(f"contract_cumulative busy share "
          f"{'not measured' if busy is None else f'{busy:.3f}'} of "
          f"{wall_us / 1e3:.1f} ms, {count} device activities; top "
          f"{[(n[:40], round(us, 1)) for n, us in top]}", flush=True)
    flops, width = _tn_counted(lambda: energy_tn.contract_cumulative(sites))
    print(f"  {L} steps: flops {flops:.4e}, width {width:.2f}, "
          f"{flops / secs / 1e12:.3f} TFLOP/s", flush=True)
    _tn_check_energy("contract_cumulative", e_cum / n_auto, e_host / n_host)

    # "auto" on the energy network: searched, not run
    info, search = _tn_search(energy_tn, "auto", output_inds=())
    print(f"<psi|H|psi> by 'auto' (searched, not run): path search "
          f"{search:.3f} s, flops {info.flops:.4e}, width "
          f"{info.width:.2f}", flush=True)

    # the same ratio by quimb_tpu's greedy path, the heaviest contraction
    # the port runs
    info, search = _tn_search(energy_tn, "greedy", output_inds=())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    e_greedy, secs = _tn_timed(lambda: energy_tn.contract(
        all, output_inds=(), optimize="greedy"))
    e_greedy = _tn_scalar(e_greedy)
    peak = torch.cuda.max_memory_allocated()
    _tn_report("<psi|H|psi> by 'greedy'", info, search, secs)
    print(f"  its largest intermediate {2 ** info.width * 8 / 1e9:.2f} GB "
          f"(float64); torch.cuda.max_memory_allocated {peak / 1e9:.2f} GB "
          f"(allocated before {m0 / 1e9:.2f} GB)", flush=True)
    _tn_check_energy("greedy", e_greedy / n_auto, e_host / n_host)
    torch.cuda.empty_cache()

    _tn_compress_check(ket)
    n = {k: ck.LAUNCHES[k] - before[k] for k in before}
    if sum(n.values()):
        raise AssertionError(f"the tensor-network layer launched the "
                             f"sandwich kernels {n}")
    print(f"tensor-network phase: {time.perf_counter() - t_phase:.1f} s, "
          f"sandwich launches {n}", flush=True)


def _tn_check_energy(what, ratio, ref):
    rel = abs(ratio - ref) / abs(ref)
    rel_ref = abs(ratio - E_REF) / abs(E_REF)
    print(f"<psi|H|psi>/<psi|psi> by {what}: {ratio:.12f}, relative to the "
          f"host sweep {rel:.3e} (bound {TN_ENERGY_TOL:.0e}), to E_REF "
          f"{rel_ref:.3e} (bound {E_REL_TOL[torch.float64]:.0e})",
          flush=True)
    if not (rel < TN_ENERGY_TOL and rel_ref < E_REL_TOL[torch.float64]):
        raise AssertionError(f"the energy by {what} misses its bounds")


def _tn_compress_check(ket):
    """canonize_between and compress_between at bond 64 on a copy of the
    ket, through the port's array_split, against a direct rank-128
    truncation by torch.linalg.svd; and tensor_split of the fused pair."""
    a, b = f"I{TN_BOND - 1}", f"I{TN_BOND}"
    kc = ket.copy()
    norm0 = float(kc.make_norm().contract(all)) ** 0.5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kc.canonize_between(a, b)
    torch.cuda.synchronize()
    t_canon = time.perf_counter() - t0
    norm1 = float(kc.make_norm().contract(all)) ** 0.5
    pair = quimb_torch.tensor_contract(kc[a], kc[b])
    left = (f"k{TN_BOND - 1}", f"p{TN_BOND - 1}")
    right = (f"p{TN_BOND}", f"k{TN_BOND + 1}")
    theta = pair.transpose(*left, *right).data
    theta = theta.reshape(theta.shape[0] * theta.shape[1], -1)
    U, s, VH = torch.linalg.svd(theta, full_matrices=False)
    k = TN_MAX_BOND
    ref = (U[:, :k] * s[:k]) @ VH[:k]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kc.compress_between(a, b, max_bond=k, cutoff=0.0)
    torch.cuda.synchronize()
    t_comp = time.perf_counter() - t0
    bond = kc.bond_size(a, b)
    got = quimb_torch.tensor_contract(kc[a], kc[b]).transpose(
        *left, *right).data.reshape(ref.shape)
    err = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
    tl, tr = pair.split(left, max_bond=k, cutoff=0.0, get="tensors")
    got_split = quimb_torch.tensor_contract(tl, tr).transpose(
        *left, *right).data.reshape(ref.shape)
    err_split = float(torch.linalg.norm(got_split - ref)
                      / torch.linalg.norm(ref))
    canon = abs(norm1 - norm0) / norm0
    print(f"bond {TN_BOND} (was {ket.bond_size(a, b)}): canonize_between "
          f"{t_canon * 1e3:.2f} ms, norm {norm0:.15f} -> {norm1:.15f} "
          f"(relative {canon:.3e}, bound {TN_CANON_TOL:.0e}); "
          f"compress_between to {bond} in {t_comp * 1e3:.2f} ms, product "
          f"against the rank-{k} SVD truncation {err:.3e}, tensor_split's "
          f"{err_split:.3e} (bound {TN_SPLIT_TOL:.0e}); s[{k - 1}] "
          f"{float(s[k - 1]):.3e}, s[{k}] {float(s[k]):.3e}", flush=True)
    if bond != k or tl.shape[-1] != k:
        raise AssertionError(f"the compressed bond is {bond}, not {k}")
    if not (err < TN_SPLIT_TOL and err_split < TN_SPLIT_TOL):
        raise AssertionError("the compressed pair misses the truncation")
    if not canon < TN_CANON_TOL:
        raise AssertionError("canonize_between changed the ket's norm")


# -- phase 10: the TEBD quench ------------------------------------------------

TEBD_L, TEBD_CHI, TEBD_STEPS, TEBD_DT, TEBD_CUTOFF = 64, 64, 20, 0.05, 1e-10
TEBD_REAL = {torch.complex128: torch.float64, torch.complex64: torch.float32}
# bounds on the largest distance of the 20 entropies from the reference
# curve: about 2.5 times quimb_tpu's own in complex128 (8.0e-5 on a CPU);
# complex64 with a truncation mask that keeps the weight above the cutoff
# read 7.8e-5 on an H100. And on |<psi|psi> - 1| of the final state: in
# complex64 that is the float32 rounding of 64 B-form tensors, which on a
# CPU wanders between 1e-6 and 2e-5 from step to step, with no drift
TEBD_ENT_TOL = {torch.complex128: 2e-4, torch.complex64: 2e-4}
TEBD_NORM_TOL = {torch.complex128: 1e-8, torch.complex64: 1e-4}
# quimb_tpu's own complex128 curve of this quench, from
# ``JAX_PLATFORMS=cpu QUIMB_TPU_X64=1 python benchref/measure_tpu_tebd.py
# 64 64 20 0.05`` on a CPU (printed against, not gated)
QUIMB_TPU_CPU_C128 = np.array([
    0.0075482694509380124, 0.025140156527633736, 0.04982170841521701,
    0.07992733626961111, 0.11423208603258764, 0.15175386766845503,
    0.1916759939046804, 0.23331062892568086, 0.27607940365553924,
    0.31950184589079034, 0.3631872774508482, 0.4068279870093512,
    0.4501926988774144, 0.49311952447586543, 0.5355083258439821,
    0.5773123813641874, 0.6185295808309791, 0.6591932696663401,
    0.6993631970176517, 0.7391166856784459,
])
# cuSOLVER's SVD drivers, timed on one parity sweep's batch, beside the
# quench's own route (decomp.safe_svd: the checked gesvdj in complex128),
# and the bound on ||U^H U - I||_2 and ||VH VH^H - I||_2 that the route
# must hold there: the Hastings update needs isometric factors
SVD_DRIVERS = ("gesvd", "gesvdj", None, "safe_svd")
SVD_ORTHO_TOL = {torch.complex128: 1e-12, torch.complex64: 1e-5}


def _tebd_reference():
    """jcmgray/quimb's complex128 run of the quench (entropies, err)."""
    ref = json.loads(Path("benchref/REFBASE.json").read_text())
    ref = ref["tebd_L64_chi64"]
    return np.asarray(ref["entropies"]), ref["err"]


def _busy_share(fn):
    """Device time over wall time of ``fn()``, the kernels that took most
    of it and the count of device activities, from torch.profiler; None
    for the share where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, count = {}, 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            count += 1
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return (busy / wall_us if busy > 0 else None), top, wall_us, count


def _theta_batch(tebd):
    """The even bonds' theta = ls . B1 B2 of the state, (32, 128, 128)."""
    Bs, ls = tebd._vidal
    idx = tebd._pair_index(0)
    m, chi, d = idx.numel(), Bs.shape[1], Bs.shape[2]
    th = torch.einsum("mlpc,mcqr->mlpqr", Bs[idx], Bs[idx + 1])
    return (th * ls[idx][:, :, None, None, None]).reshape(m, chi * d, d * chi)


def svd_driver_table(theta):
    """Each SVD driver on the batch ``theta``: median wall ms of one call,
    and the largest ||U^H U - I||_2 and ||VH VH^H - I||_2 over the batch."""
    eye = torch.eye(theta.shape[-1], dtype=theta.dtype, device=theta.device)
    print(f"SVD drivers on {tuple(theta.shape)} {theta.dtype} (one parity "
          f"sweep's batch):", flush=True)
    rows = {}
    for driver in SVD_DRIVERS:
        if driver == "safe_svd":
            svd = functools.partial(decomp.safe_svd, theta)
            name = "the quench's route, decomp.safe_svd (checked gesvdj" + (
                ", via complex128)" if theta.dtype == torch.complex64
                else ")")
        else:
            svd = functools.partial(torch.linalg.svd, theta,
                                    full_matrices=False, driver=driver)
            name = driver or "default"
        try:
            U, _, VH = svd()
        except torch.linalg.LinAlgError as err:
            # a driver of cuSOLVER alone may fail; the route may not
            if driver == "safe_svd":
                raise
            print(f"  {name}: failed ({str(err).splitlines()[0]})",
                  flush=True)
            continue
        ms = _host_ms(svd)
        ortho_u = torch.linalg.matrix_norm(decomp.dag(U) @ U - eye, 2)
        ortho_v = torch.linalg.matrix_norm(VH @ decomp.dag(VH) - eye, 2)
        rows[driver] = (ms, ortho_u.max().item(), ortho_v.max().item())
        print(f"  {name}: {ms:.3f} ms, ||U^H U - I||_2 "
              f"{rows[driver][1]:.3e}, ||VH VH^H - I||_2 "
              f"{rows[driver][2]:.3e}", flush=True)
    return rows


def _host_norm(As):
    """<psi|psi> of a list state, in complex128 numpy."""
    env = np.ones((1, 1))
    for A in As:
        A = to_host(A).astype(np.complex128)
        env = np.einsum("ab,apx,bpy->xy", env, A, A.conj())
    return env.reshape(()).real


def run_tebd_path(dtype):
    """The quench in ``dtype`` through the entry points, with no device."""
    ref_ent, ref_err = _tebd_reference()
    psi0 = quimb_torch.MPS_neel_state(TEBD_L, dtype=TEBD_REAL[dtype])
    H = quimb_torch.ham_1d_heis(TEBD_L)
    opts = {"max_bond": TEBD_CHI, "cutoff": TEBD_CUTOFF}
    if not all(A.is_cuda for A in psi0):
        raise AssertionError("MPS_neel_state with no device is not on the GPU")

    warm = quimb_torch.TEBD(psi0, H, split_opts=opts)
    t0 = time.perf_counter()
    warm.update_to(2 * TEBD_DT, dt=TEBD_DT)
    torch.cuda.synchronize()
    print(f"TEBD {dtype} warm-up (2 steps on a copy): "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    _reset_launches()
    redos = dict(decomp.SVD_REDOS)
    tebd = quimb_torch.TEBD(psi0, H, split_opts=opts)
    entropies, seconds = [], []
    for k in range(1, TEBD_STEPS + 1):
        t0 = time.perf_counter()
        tebd.update_to(k * TEBD_DT, dt=TEBD_DT)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        entropies.append(tebd.entropy(TEBD_L // 2))
        print(f"TEBD {dtype} step {k}: {seconds[-1]:.4f} s, S(L/2) "
              f"{entropies[-1]:.10f}", flush=True)
    launches = sum(ck.LAUNCHES.values())
    print(f"TEBD {dtype}: {statistics.mean(seconds):.4f} s per step (mean of "
          f"{TEBD_STEPS}; median {statistics.median(seconds):.4f}), "
          f"sandwich launches {dict(ck.LAUNCHES)}", flush=True)

    Bs, ls = tebd._vidal
    for name, t, want in (("Bs", Bs, dtype), ("ls", ls, TEBD_REAL[dtype])):
        finite = bool(torch.isfinite(t).all())
        if not (t.is_cuda and t.dtype == want and finite):
            raise AssertionError(f"TEBD stack {name}: {t.device} {t.dtype}, "
                                 f"or not finite")
    dist = np.abs(np.asarray(entropies) - ref_ent)
    print(f"TEBD {dtype} entropies against the reference curve: max "
          f"{dist.max():.3e} (bound {TEBD_ENT_TOL[dtype]:.0e}) at step "
          f"{int(dist.argmax()) + 1}", flush=True)
    own = np.abs(np.asarray(entropies) - QUIMB_TPU_CPU_C128).max()
    print(f"  against quimb_tpu's complex128 CPU curve: max {own:.3e}",
          flush=True)
    rel_err = abs(tebd.err - ref_err) / ref_err
    print(f"TEBD {dtype} err {tebd.err!r} against {ref_err!r}: relative "
          f"{rel_err:.3e}; discarded weight (trunc_err) {tebd.trunc_err!r}",
          flush=True)
    if not dist.max() <= TEBD_ENT_TOL[dtype]:
        raise AssertionError("TEBD entropies miss the reference curve")
    if not rel_err <= 1e-9:
        raise AssertionError("TEBD err misses the reference's")
    if launches:
        raise AssertionError("TEBD launched a sandwich kernel")

    print(f"TEBD {dtype}: SVD batches that gesvdj failed on and gesvd "
          f"redid in the {TEBD_STEPS} steps: "
          f"{decomp.SVD_REDOS[dtype] - redos[dtype]}",
          flush=True)
    theta = _theta_batch(tebd)
    rows = svd_driver_table(theta)
    if not max(rows["safe_svd"][1:]) <= SVD_ORTHO_TOL[dtype]:
        raise AssertionError("the SVD route of the quench lost "
                             "orthogonality")
    share, top, wall_us, count = _busy_share(
        lambda: warm.update_to(3 * TEBD_DT, dt=TEBD_DT))
    print(f"TEBD {dtype} step 3 of the copy under torch.profiler: "
          f"{wall_us / 1e3:.3f} ms wall, {count} device activities, busy "
          f"share " + ("not measured" if share is None else f"{share:.4f}"),
          flush=True)
    for name, us in top:
        print(f"  {us / 1e3:.3f} ms  {name[:100]}", flush=True)

    nrm = _host_norm(tebd.pt)
    print(f"TEBD {dtype} final state: bonds "
          f"{max(A.shape[2] for A in tebd.pt)}, |<psi|psi> - 1| "
          f"{abs(nrm - 1):.3e} (bound {TEBD_NORM_TOL[dtype]:.0e})", flush=True)
    if not abs(nrm - 1) <= TEBD_NORM_TOL[dtype]:
        raise AssertionError("the TEBD state lost its norm")


# -- phase 11: the exact 20-qubit core ----------------------------------------

EXACT_N, EXACT_T, EXACT_NT, EXACT_NCV = 20, 1.0, 4, 20
# float64 / complex128 end to end: quimb_tpu's own CPU run of the harness
# reaches REFBASE to 5e-15 (energy) and 7e-15 (<Z_0>)
EXACT_E_TOL, EXACT_Z_TOL, EXACT_NORM_TOL, EXACT_MV_TOL = (1e-10, 1e-9,
                                                          1e-10, 1e-12)


def _exact_reference():
    """jcmgray/quimb's run of the exact core (energy, <Z_0> at t = k/4)."""
    ref = json.loads(Path("benchref/REFBASE.json").read_text())["exact20"]
    return ref["groundenergy"], np.asarray(ref["z0_checkpoints"])


@contextlib.contextmanager
def _counted_matvecs():
    """Counts the LocalTermsHam matvecs made inside the block."""
    count = [0]
    matvec = core.LocalTermsHam.matvec

    def counted(self, x):
        count[0] += 1
        return matvec(self, x)

    core.LocalTermsHam.matvec = counted
    try:
        yield count
    finally:
        core.LocalTermsHam.matvec = matvec


def _timed(fn):
    """(result, seconds) of ``fn()`` on a synchronised host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _on_card(what, t, dtype):
    if not (t.is_cuda and t.dtype == dtype and bool(torch.isfinite(t).all())):
        raise AssertionError(f"{what}: {t.device} {t.dtype}, or not finite")


def exact_matvec_table(H):
    """The matvec of the LocalTermsHam and of the ELL SparseHam of ``H``
    on the card, in float64 and complex128: CUDA-event ms against the
    bound of reading x and writing H x once, and the agreement of the
    two, gated at EXACT_MV_TOL relative."""
    lt = quimb_torch.device_operator(H)
    ell, build_s = _timed(lambda: core.SparseHam(H))
    _on_card("LocalTermsHam terms", lt.mats[0], torch.float64)
    _on_card("SparseHam values", ell.vals, torch.float64)
    n = lt.shape[0]
    print(f"exact core operators: LocalTermsHam of {len(lt.sites)} terms; "
          f"ELL SparseHam ({n} x {ell.cols.shape[1]}, built on the host in "
          f"{build_s:.3f} s)", flush=True)
    rng = np.random.default_rng(SEED)
    for dtype in (torch.float64, torch.complex128):
        host = rng.standard_normal(n)
        if dtype.is_complex:
            host = host + 1j * rng.standard_normal(n)
        x = _cuda(host, dtype)
        want = lt.matvec(x)
        rel = (torch.linalg.norm(ell.matvec(x) - want)
               / torch.linalg.norm(want)).item()
        nbytes = 2 * n * dtype.itemsize
        bound_ms = nbytes / PEAK_BYTES * 1e3
        # the loop's own traffic: the zero fill, then per term one read of
        # x and a read and a write of the output
        loop_bytes = (1 + 3 * len(lt.sites)) * n * dtype.itemsize
        ms = {"LocalTermsHam": [], "SparseHam": []}
        for name in ("LocalTermsHam", "SparseHam", "SparseHam",
                     "LocalTermsHam"):
            op = lt if name == "LocalTermsHam" else ell
            ms[name].append(_event_ms(op.matvec, (x,), reps=20))
        print(f"exact matvec {dtype}: LocalTermsHam {ms['LocalTermsHam']} "
              f"ms, ELL SparseHam {ms['SparseHam']} ms; bound (2 x {n} x "
              f"{dtype.itemsize} B over {PEAK_BYTES / 1e12:.2f} TB/s) "
              f"{bound_ms:.4f} ms; the per-term loop moves "
              f"{loop_bytes / 1e9:.3f} "
              f"GB ({loop_bytes / PEAK_BYTES * 1e3:.4f} ms at that rate); "
              f"ELL against LocalTermsHam: relative {rel:.3e} (bound "
              f"{EXACT_MV_TOL:.0e})", flush=True)
        if not rel <= EXACT_MV_TOL:
            raise AssertionError("the ELL matvec disagrees with the "
                                 "LocalTermsHam one")
        if dtype.is_complex:
            terms = []
            for sites, m in zip(lt.sites, lt.mats):
                one = core.LocalTermsHam(lt.dims, {sites: to_host(m)})
                ms_one = _event_ms(one.matvec, (x,), reps=10)
                terms.append(f"{sites}: {ms_one:.4f}")
            print(f"  each term alone (zero fill + one product), ms: "
                  + ", ".join(terms), flush=True)
        del x, want
    del ell
    torch.cuda.empty_cache()


def run_exact_path():
    """The exact core through the entry points, with no device."""
    e_ref, z_ref = _exact_reference()
    H, build_s = _timed(lambda: quimb_torch.ham_heis(EXACT_N, sparse=True))
    print(f"exact core: ham_heis({EXACT_N}, sparse=True) on the host: "
          f"{build_s:.3f} s, {H.nnz} nonzeros", flush=True)
    exact_matvec_table(H)

    energies = []
    for label in ("cold", "warm"):
        with _counted_matvecs() as count:
            e, secs = _timed(lambda: quimb_torch.groundenergy(H))
        _on_card("groundenergy", e, torch.float64)
        energies.append(float(e))
        print(f"groundenergy ({label}): {energies[-1]!r} in {secs:.3f} s, "
              f"{count[0]} matvecs, {count[0] // EXACT_NCV} Lanczos restarts "
              f"of {EXACT_NCV}", flush=True)
    psi, secs = _timed(lambda: quimb_torch.groundstate(H))
    _on_card("groundstate", psi, torch.float64)
    op = quimb_torch.device_operator(H)
    _on_card("device_operator", op.mats[0], torch.float64)
    rayleigh = torch.vdot(psi[:, 0], op @ psi[:, 0]).item() / torch.vdot(
        psi[:, 0], psi[:, 0]).item()
    print(f"groundstate: {secs:.3f} s, its Rayleigh quotient {rayleigh!r}",
          flush=True)
    rel = max(abs(e - e_ref) for e in (*energies, rayleigh)) / abs(e_ref)
    print(f"exact core energy against REFBASE's {e_ref!r}: relative "
          f"{rel:.3e} (bound {EXACT_E_TOL:.0e})", flush=True)
    if not rel <= EXACT_E_TOL:
        raise AssertionError("the exact core's energy misses REFBASE's")
    share, top, wall_us, count = _busy_share(
        lambda: quimb_torch.groundenergy(H))
    print(f"groundenergy under torch.profiler: {wall_us / 1e3:.3f} ms wall, "
          f"{count} device activities, busy share "
          + ("not measured" if share is None else f"{share:.4f}"), flush=True)
    for name, us in top:
        print(f"  {us / 1e3:.3f} ms  {name[:100]}", flush=True)
    del psi, op

    p0 = quimb_torch.computational_state("01" * (EXACT_N // 2))
    _on_card("computational_state", p0, torch.complex128)
    bit0 = (torch.arange(2**EXACT_N, device=p0.device) >> (EXACT_N - 1)) & 1
    zdiag = (1 - 2 * bit0).to(torch.float64)

    def z0(psi):
        p = torch.abs(psi.reshape(-1)) ** 2
        return (torch.sum(p * zdiag) / torch.sum(p)).item()

    warm = quimb_torch.Evolution(p0, H, method="expm")
    _, secs = _timed(lambda: warm.update_to(EXACT_T / EXACT_NT))
    print(f"Evolution warm-up (one update on a copy): {secs:.3f} s",
          flush=True)
    evo = quimb_torch.Evolution(p0, H, method="expm")
    zs, seconds = [], []
    for k in range(1, EXACT_NT + 1):
        with _counted_matvecs() as count:
            _, secs = _timed(lambda: evo.update_to(EXACT_T * k / EXACT_NT))
        seconds.append(secs)
        zs.append(z0(evo.pt))
        print(f"Evolution t={evo.t:.3f}: <Z_0> {zs[-1]!r}, {secs:.3f} s, "
              f"{count[0]} matvecs", flush=True)
    _on_card("Evolution state", evo.pt, torch.complex128)
    dist = np.abs(np.asarray(zs) - z_ref)
    nrm = torch.linalg.norm(evo.pt).item()
    print(f"Evolution: {statistics.mean(seconds):.3f} s per update (mean of "
          f"{EXACT_NT}); <Z_0> against REFBASE: max {dist.max():.3e} (bound "
          f"{EXACT_Z_TOL:.0e}); | |psi| - 1 | {abs(nrm - 1):.3e} (bound "
          f"{EXACT_NORM_TOL:.0e})", flush=True)
    if not dist.max() <= EXACT_Z_TOL:
        raise AssertionError("the exact core's <Z_0> misses REFBASE's")
    if not abs(nrm - 1) <= EXACT_NORM_TOL:
        raise AssertionError("the evolved state lost its norm")
    share, top, wall_us, count = _busy_share(
        lambda: warm.update_to(2 * EXACT_T / EXACT_NT))
    print(f"expm update under torch.profiler: {wall_us / 1e3:.3f} ms wall, "
          f"{count} device activities, busy share "
          + ("not measured" if share is None else f"{share:.4f}"), flush=True)
    for name, us in top:
        print(f"  {us / 1e3:.3f} ms  {name[:100]}", flush=True)
    del warm, evo
    torch.cuda.empty_cache()


# -- phase 13: the 53-qubit circuit -------------------------------------------

CIRC_N, CIRC_DEPTH, CIRC_SAMPLES, CIRC_SEED = 53, 12, 20, 42
# relative distance of each amplitude from jcmgray/quimb's (REFBASE): the
# port's complex128 run on a CPU reaches 3e-12 (float64 round-off over a
# 466-tensor contraction); complex64 reaches the order of quimb_tpu's TPU
# run (3e-5)
CIRC_AMP_TOL = {torch.complex128: 1e-9, torch.complex64: 1e-3}
# quimb_tpu's strings of ``Circuit.sample(20, seed=42)`` on this circuit,
# from ``JAX_PLATFORMS=cpu python scripts/circuit53_samples.py`` on a CPU
CIRC_REF_SAMPLES = (
    "10111110010110010010100001001010010100111100000110101",
    "01011101001111010110000111000110100100110011110001110",
    "11000111110110111010010000011110000010000110010010110",
    "10000010010000011111000101010010111111111100100111100",
    "01010110111001101110111011100001100110011011011001000",
    "11000010101100010010100011100000110001100101100101111",
    "10001110010001111110011001101010010001011100101000101",
    "11011011000100111001001011111000001111011001000000001",
    "01111011001010101000000111100010000111000011100100000",
    "01101010100010010010000000010111000011110010010010110",
    "01000010100011101000110110000011100111100010101110110",
    "10100110000000001001011011111010011100001000011110111",
    "01011110011000000111101011110111110000011101100101111",
    "10000000110111000101100011010110010011101101011101110",
    "01100111011110000000000101100011100001010000111100010",
    "01011100111100111101010011100111010001110000111100101",
    "00101010100001100101101000010110010001100110111001111",
    "01001101100011111010011001110001110000110111010000000",
    "10011001000001100010001000000010111100011011011101110",
    "01010010100010001111100001011111100100110011100011111",
)


def _circuit_qasm():
    """benchref/circuit53.py's OpenQASM 2 string (numpy only, loaded by
    its path: it is no part of the package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "circuit53", "benchref/circuit53.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.qasm_circuit(CIRC_N, CIRC_DEPTH)


def _circuit_reference():
    """REFBASE's amplitudes: amp0, then the four bitstrings of
    benchref/measure_tpu_circuit53.py (from np.random.default_rng(0))."""
    ref = json.loads(Path("benchref/REFBASE.json").read_text())["circuit53"]
    amps = {"0" * CIRC_N: complex(*ref["amp0"])}
    rng = np.random.default_rng(0)
    for _ in range(4):
        b = "".join(rng.choice(["0", "1"], size=CIRC_N))
        amps[b] = complex(*ref["amps"][b])
    return amps


@contextlib.contextmanager
def _pair_steps(circ):
    """Counts, inside the block, the pairwise contraction steps by the
    kind of their operands ("numpy" for the host rewrites), and the
    circuit's final contractions by the devices their operands lay on."""
    from quimb_torch.ops import contraction

    steps, finals = {}, {}
    pair = contraction._pair_contract
    final = circ._contract

    def counted(a, la, b, lb, lo):
        kind = a.device.type if isinstance(a, torch.Tensor) else "numpy"
        steps[kind] = steps.get(kind, 0) + 1
        return pair(a, la, b, lb, lo)

    def recorded(tn, *args, **kwargs):
        out = final(tn, *args, **kwargs)
        for t in tn.tensor_map.values():
            kind = (t.data.device.type if isinstance(t.data, torch.Tensor)
                    else "numpy")
            finals[kind] = finals.get(kind, 0) + 1
        return out

    contraction._pair_contract = counted
    circ._contract = recorded
    try:
        yield steps, finals
    finally:
        contraction._pair_contract = pair
        del circ._contract


def _circuit_amplitudes(circ, dtype, ref):
    """Each amplitude cold, then warm, gated against REFBASE; the warm
    call split into the host rewrite and the card's contraction."""
    from quimb_torch.ops.contraction import contract_backend

    worst = 0.0
    for b, want in ref.items():
        _, cold_s = _timed(lambda: circ.amplitude(b))
        with _pair_steps(circ) as (steps, finals):
            amp, warm_s = _timed(lambda: circ.amplitude(b))
        if set(finals) != {"cuda"}:
            raise AssertionError(f"amplitude's final operands lay on "
                                 f"{finals}, not only on the card")
        rehearsal, host_s = _timed(lambda: circ.amplitude(b, rehearse=True))
        tn, expr = rehearsal["tn"], rehearsal["tree"]
        tn.apply_to_arrays(lambda a: torch.as_tensor(a, device="cuda"))
        _, card_s = _timed(lambda: tn.contract(..., optimize="auto"))
        rel = abs(amp - want) / abs(want)
        worst = max(worst, rel)
        print(f"circuit {dtype} amplitude {b[:12]}...: {amp!r}, relative "
              f"to REFBASE {rel:.3e}; cold {cold_s:.3f} s, warm "
              f"{warm_s:.3f} s = host rewrite and path (rehearse=True) "
              f"{host_s:.3f} s + the rest; the contraction alone on the "
              f"card {card_s * 1e3:.2f} ms ({len(tn.tensor_map)} tensors, "
              f"{len(expr.steps)} steps, flops {expr.flops:.3e}, width "
              f"{expr.width:.1f}); pairwise steps by operand {steps}",
              flush=True)
    print(f"circuit {dtype}: largest relative distance from REFBASE "
          f"{worst:.3e} (bound {CIRC_AMP_TOL[dtype]:.0e})", flush=True)
    if not worst <= CIRC_AMP_TOL[dtype]:
        raise AssertionError(f"circuit {dtype} amplitudes miss REFBASE")
    b0 = "0" * CIRC_N
    host_amp, host_s = _timed(lambda: circ.amplitude(b0, backend="numpy"))
    rel = abs(host_amp - circ.amplitude(b0)) / abs(host_amp)
    tn = circ.amplitude(b0, rehearse=True)["tn"]
    with contract_backend("numpy"):
        _, host_c_s = _timed(lambda: tn.contract(..., optimize="auto"))
    print(f"circuit {dtype} amp0 by backend='numpy': {host_s:.3f} s, its "
          f"contraction alone on the host {host_c_s * 1e3:.2f} ms, relative "
          f"to the card's {rel:.3e}", flush=True)
    share, top, wall_us, count = _busy_share(lambda: circ.amplitude(b0))
    print(f"circuit {dtype} warm amp0 under torch.profiler: "
          f"{wall_us / 1e3:.1f} ms wall, {count} device activities, busy "
          "share " + ("not measured" if share is None else f"{share:.4f}"),
          flush=True)
    for name, us in top:
        print(f"  {us / 1e3:.3f} ms  {name[:100]}", flush=True)


def _marginal_exprs(circ):
    """The circuit's cached marginal expressions, as their cache entries:
    (the batched ones, the single ones)."""
    cache = circ._region_expr_cache
    keys = [k for k in list(cache) if cache[k] != "fallback"]
    return ([cache[k] for k in keys if k[0] == "batch"],
            [cache[k] for k in keys if k[0] != "batch"])


def run_circuit_path():
    """The 53-qubit circuit through the entry points, with no device."""
    qasm = _circuit_qasm()
    ref = _circuit_reference()
    _reset_launches()
    for dtype in (torch.complex128, torch.complex64):
        circ, secs = _timed(lambda: quimb_torch.tensor.Circuit
                            .from_openqasm2_str(qasm, dtype=dtype))
        if circ.device.type != "cuda":
            raise AssertionError(f"Circuit with no device is on "
                                 f"{circ.device}, not the GPU")
        print(f"circuit {dtype}: built from OpenQASM in {secs:.3f} s, "
              f"{circ.num_gates} gates, {circ._psi.num_tensors} tensors "
              f"(host arrays)", flush=True)
        _circuit_amplitudes(circ, dtype, ref)
        if dtype == torch.complex128:
            main_circ = circ

    with _pair_steps(main_circ) as (steps, finals):
        samples, secs = _timed(lambda: tuple(main_circ.sample(
            CIRC_SAMPLES, seed=CIRC_SEED)))
    batched, single = _marginal_exprs(main_circ)
    print(f"circuit sample({CIRC_SAMPLES}, seed={CIRC_SEED}): {secs:.3f} s; "
          f"{len(batched)} of {-(-CIRC_N // 10)} groups by a batched "
          "expression "
          + ", ".join(f"({e[0].flops:.3e} flops, width {e[0].width:.1f})"
                      for e in batched)
          + f"; {len(single)} single marginal expressions "
          + ", ".join(f"({e[0].flops:.3e} flops, width {e[0].width:.1f})"
                      for e in single)
          + "; the other groups by the per-sample route; pairwise steps by "
          f"operand {steps}; operands of the per-sample final contractions "
          f"by device {finals}", flush=True)
    # the busy share over a short draw from a fresh circuit: profiling the
    # whole draw (about a million device activities) takes minutes
    fresh = quimb_torch.tensor.Circuit.from_openqasm2_str(qasm)
    share, top, wall_us, count = _busy_share(
        lambda: list(fresh.sample(2, seed=CIRC_SEED)))
    print(f"circuit sample(2, seed={CIRC_SEED}) of a fresh circuit under "
          f"torch.profiler: {wall_us / 1e6:.3f} s, {count} device "
          "activities, busy share " + ("not measured" if share is None
                                       else f"{share:.4f}"), flush=True)
    for name, us in top:
        print(f"  {us / 1e3:.3f} ms  {name[:100]}", flush=True)
    for i, (got, want) in enumerate(zip(samples, CIRC_REF_SAMPLES)):
        print(f"  sample {i}: {got} {'==' if got == want else '!='} "
              f"quimb_tpu's", flush=True)
    if samples != CIRC_REF_SAMPLES:
        raise AssertionError("the circuit's samples differ from quimb_tpu's")
    where = {a.device.type for entry in (*batched, *single)
             for a in entry[1]}
    if not set(finals) <= {"cuda"} or not where <= {"cuda"}:
        raise AssertionError(f"sampling's final operands lay on {finals}, "
                             f"its cached expressions' on {where}")
    if sum(ck.LAUNCHES.values()):
        raise AssertionError(f"the circuit launched sandwich kernels "
                             f"{dict(ck.LAUNCHES)}")


def main():
    t_start = time.perf_counter()
    check_device()
    build_kernels()
    max_abs_err, north = check_kernel()
    times = {dtype: time_kernel(north, dtype) for dtype in KERNEL_TOLS}
    launches = {}
    dmrg, launches[torch.float32] = run_main_path(torch.float32)
    check_splits(bond_breakdown(dmrg))
    launches[torch.float32] += run_parallel_path(dmrg)
    del dmrg
    dmrg, launches[torch.float64] = run_main_path(torch.float64)
    check_splits(bond_breakdown(dmrg))
    launches[torch.float64] += run_dmrg1_path(dmrg)
    run_tn_layer(dmrg)
    del dmrg
    for dtype in TEBD_REAL:
        run_tebd_path(dtype)
    torch.cuda.empty_cache()
    run_exact_path()
    torch.cuda.empty_cache()
    run_circuit_path()
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [{
        "name": "sandwich_matvec",
        "route": "cuda",
        "source": KERNEL_SOURCE[dtype],
        "replaces": "quimb_tpu/ops/pallas_kernels.py:68",
        "launches": launches[dtype],
        "max_abs_err": max_abs_err[dtype],
        "ms": times[dtype][0],
        "plain_ms": times[dtype][1],
        "bound_ms": sandwich_bound(dtype)[0],
        "bound_by": sandwich_bound(dtype)[1],
        # the plain version is the one library call that computes the
        # product, torch.einsum("xmk,kl,xln->mn")
        "library_ms": times[dtype][1],
    } for dtype in KERNEL_TOLS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
