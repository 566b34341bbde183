"""Smoke run of quimb_torch's main path on one CUDA GPU.

Run from the root of the repository, on a machine with an NVIDIA Hopper
GPU and the CUDA toolkit::

    python3 chip_smoke.py

It drives the DMRG2 ground-state search of the spin-1/2 Heisenberg chain
at L=128, chi=256 through the package's entry points (``MPO_ham_heis``,
``MPS_rand_state``, ``DMRG2.sweep``), twice: on a float32 state, with
every effective-Hamiltonian matvec in the hand-written 3xTF32 sandwich
kernel, and on a float64 state, with every matvec in the hand-written
FP64 tensor-core (DMMA) kernel. Its phases, each fatal on failure:

1. the device: a CUDA GPU is required; its name and power limit are
   printed;
2. the build of ``quimb_torch/csrc`` with nvcc, timed; ptxas must report
   no spills, and the float64 kernel's SASS must hold DMMA instructions;
3. the kernels against their plain einsum (in float64) on the card, in
   float32 (3xTF32) and float64 (DMMA) at the main paths' shapes; two
   applications of one prepared operand set, and a one-shot call, must
   agree bitwise; for each dtype, CUDA-event times of the matvec and the
   plain einsum at the north-star shape, in the order plain, kernel,
   kernel, plain, the prepare step's time and each launch's device time
   (``torch.profiler``);
4. the float32 main path: right sweeps at max_bond 64, 128, 256, 256,
   256, then one left sweep; each sweep must launch the float32 kernel
   at least ncv * restarts * (L - 1) times and the float64 one never;
   the final state's energy, evaluated in float64 on the host, must lie
   within a relative 2e-5 of E_REF;
5. where one bulk bond's time goes, phase by phase;
6. the float64 path: the same schedule on a float64 state; each sweep
   must launch the float64 kernel at least ncv * restarts * (L - 1)
   times and the float32 one never; the host energy must lie within a
   relative 1e-6 of E_REF; then phase 5 on one of its bulk bonds.

The line before the last is the kernels' JSON summary, one entry per
kernel with its launches on its own path; the last line is
``{"ok": true, "device": {...}}``.
"""

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
from quimb_torch.ops.backend import to_host
from quimb_torch.tensor.tn1d import dmrg as D

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
    w, M, K1, K2, N = CHECK_SHAPES[0]
    flop = 2 * w * (M * K1 * K2 + M * K2 * N)
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

    torch.cuda.synchronize()
    for name in ck.LAUNCHES:
        ck.LAUNCHES[name] = 0
    t_path = time.perf_counter()
    for direction, max_bond in sweeps:
        before = dict(ck.LAUNCHES)
        t0 = time.perf_counter()
        en = dmrg.sweep(direction, max_bond=max_bond, cutoff=0.0,
                        canonize=direction == "R")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        dmrg.energies.append(en)
        n = {k: ck.LAUNCHES[k] - before[k] for k in before}
        print(f"{dtype} sweep {direction} max_bond={max_bond}: {dt:.3f} s, "
              f"energy {en:.10f}, sandwich launches {n}", flush=True)
        if n[kernel] < min_launches or sum(n.values()) != n[kernel]:
            raise AssertionError(f"sweep launched the kernels {n}; "
                                 f"{kernel} fewer than {min_launches} "
                                 f"times, or another kernel")
    launches = ck.LAUNCHES[kernel]
    print(f"{dtype} main path: {time.perf_counter() - t_path:.3f} s, "
          f"sandwich launches {dict(ck.LAUNCHES)}", flush=True)

    for A in dmrg.state:
        if not (A.shape[0] <= CHI and A.shape[2] <= CHI and A.dtype == dtype
                and bool(torch.isfinite(A).all())):
            raise AssertionError(f"bad site tensor {tuple(A.shape)}")
    t0 = time.perf_counter()
    e64 = host_f64_energy(dmrg.state, dmrg._W)
    rel = abs(e64 - E_REF) / abs(E_REF)
    tol = E_REL_TOL[dtype]
    print(f"{dtype} state, float64 host energy {e64:.10f} "
          f"({time.perf_counter() - t0:.1f} s): delta {e64 - E_REF:.3e}, "
          f"relative {rel:.3e} (bound {tol:.0e}); last sweep "
          f"energy {dmrg.energies[-1]:.10f}", flush=True)
    if not rel < tol:
        raise AssertionError(f"energy {e64} misses E_REF {E_REF}")
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


def bond_breakdown(dmrg):
    """Wall time of each phase of one bulk bond update at chi=256."""
    i = L // 2
    lenv = dmrg._build_left_envs()[i]
    renv = dmrg._build_right_envs()[i + 2]
    W1, W2 = dmrg._W[i], dmrg._W[i + 1]
    theta0 = torch.einsum("kpc,cqr->kpqr", dmrg._A[i], dmrg._A[i + 1])
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


def main():
    check_device()
    build_kernels()
    max_abs_err, north = check_kernel()
    times = {dtype: time_kernel(north, dtype) for dtype in KERNEL_TOLS}
    dmrg, launches32 = run_main_path(torch.float32)
    bond_breakdown(dmrg)
    del dmrg
    dmrg, launches64 = run_main_path(torch.float64)
    bond_breakdown(dmrg)
    launches = {torch.float32: launches32, torch.float64: launches64}
    print(json.dumps({"kernels": [{
        "name": "sandwich_matvec",
        "route": "cuda",
        "source": KERNEL_SOURCE[dtype],
        "replaces": "quimb_tpu/ops/pallas_kernels.py:68",
        "launches": launches[dtype],
        "max_abs_err": max_abs_err[dtype],
        "ms": times[dtype][0],
        "plain_ms": times[dtype][1],
    } for dtype in KERNEL_TOLS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
