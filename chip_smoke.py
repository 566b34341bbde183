"""Smoke run of quimb_torch's main path on one CUDA GPU.

Run from the root of the repository, on a machine with an NVIDIA Hopper
GPU and the CUDA toolkit::

    python3 chip_smoke.py

It drives the 1D ground-state engine of the spin-1/2 Heisenberg chain at
L=128, chi=256 through the package's entry points (``MPO_ham_heis``,
``MPS_rand_state``, ``DMRG2``, ``DMRG1``, ``ParallelDMRG``): DMRG2 on a
float32 state, with every effective-Hamiltonian matvec in the
hand-written 3xTF32 sandwich kernel, then ParallelDMRG from that state;
DMRG2 on a float64 state, with every matvec in the hand-written FP64
tensor-core (DMMA) kernel, then DMRG1 from that state. Its phases, each
fatal on failure:

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
5. where one bulk bond's time goes, phase by phase;
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
   entropies within 2e-4 (complex128) or 2e-3 (complex64) of the
   reference curve in benchref/REFBASE.json; ``err`` within 1e-9
   relative of the reference's; the final state's norm, on the host in
   float64, within 1e-8 or 1e-5 of 1; and no sandwich kernel launched.
   Printed, not gated: the distance to quimb_tpu's own complex128 CPU
   curve, the discarded weight, the device's busy share over one step
   (``torch.profiler``), and the SVD drivers of cuSOLVER on one parity
   sweep's (32, 128, 128) batch: time and orthogonality of each.

The line before the last is the kernels' JSON summary, one entry per
kernel with its launches on its paths (DMRG2 and ParallelDMRG for
float32, DMRG2 and DMRG1 for float64; TEBD runs no hand-written kernel),
its time against the plain einsum (the one library call that computes
the same product) and its bound; the last line is
``{"ok": true, "device": {...}}``.
"""

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
    return float(env.reshape(())) / float(nrm.reshape(()))


def run_main_path(dtype):
    """The DMRG2 main path on a state of ``dtype``; returns (dmrg, its
    kernel's launches)."""
    H = quimb_torch.MPO_ham_heis(L, dtype=dtype, device="cuda")
    p0 = quimb_torch.MPS_rand_state(L, P0_BOND, seed=SEED, dtype=dtype,
                                    device="cuda")
    dmrg = quimb_torch.DMRG2(H, bond_dims=CHI, cutoffs=0.0, p0=p0)
    opts = dmrg.opts
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
    N1, _, _ = D._split_2site(theta, CHI, 0.0, "right")
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
        "split (masked SVD)": lambda: D._split_2site(theta, CHI, 0.0,
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
        # the kept columns: the mask zeroes the others, and in float32 the
        # cumulative sum that sets it need not keep a prefix
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


# -- phase 10: the TEBD quench ------------------------------------------------

TEBD_L, TEBD_CHI, TEBD_STEPS, TEBD_DT, TEBD_CUTOFF = 64, 64, 20, 0.05, 1e-10
TEBD_REAL = {torch.complex128: torch.float64, torch.complex64: torch.float32}
# bounds on the largest distance of the 20 entropies from the reference
# curve: about 2.5 times quimb_tpu's own (8.0e-5 in complex128 on a CPU,
# 7.9e-4 in complex64 on a TPU); and on |<psi|psi> - 1| of the final state.
# In complex64 that is the float32 rounding of 64 B-form tensors: on a CPU
# it wanders between 1e-6 and 2e-5 from step to step, with no drift
TEBD_ENT_TOL = {torch.complex128: 2e-4, torch.complex64: 2e-3}
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
# cuSOLVER's SVD drivers, timed on one parity sweep's batch, and the bound
# on ||U^H U - I||_2 and ||VH VH^H - I||_2 that the quench's own SVD
# driver (decomp._svd_driver) must hold there: the Hastings update needs
# isometric factors
SVD_DRIVERS = ("gesvd", "gesvdj", None)
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
        svd = functools.partial(torch.linalg.svd, theta, full_matrices=False,
                                driver=driver)
        U, _, VH = svd()
        ms = _host_ms(svd)
        ortho_u = torch.linalg.matrix_norm(decomp.dag(U) @ U - eye, 2)
        ortho_v = torch.linalg.matrix_norm(VH @ decomp.dag(VH) - eye, 2)
        rows[driver] = (ms, ortho_u.max().item(), ortho_v.max().item())
        print(f"  {driver or 'default'}: {ms:.3f} ms, ||U^H U - I||_2 "
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

    theta = _theta_batch(tebd)
    rows = svd_driver_table(theta)
    driver = decomp._svd_driver(theta)
    if not max(rows[driver][1:]) <= SVD_ORTHO_TOL[dtype]:
        raise AssertionError(f"the SVD driver of the quench, {driver}, "
                             f"lost orthogonality")
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


def main():
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
    del dmrg
    for dtype in TEBD_REAL:
        run_tebd_path(dtype)
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
