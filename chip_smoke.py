"""Smoke run of quimb_torch's main path on one CUDA GPU.

Run from the root of the repository, on a machine with an NVIDIA Hopper
GPU and the CUDA toolkit::

    python3 chip_smoke.py

It drives the DMRG2 ground-state search of the spin-1/2 Heisenberg chain
at L=128, chi=256 on a float32 state, through the package's entry points
(``MPO_ham_heis``, ``MPS_rand_state``, ``DMRG2.sweep``), with every
effective-Hamiltonian matvec in the hand-written sandwich kernel. Its
phases, each fatal on failure:

1. the device: a CUDA GPU is required; its name and power limit are
   printed;
2. the build of ``quimb_torch/csrc`` with nvcc, timed;
3. the kernel against its plain einsum (in float64) on the card, in
   float32 and float64 at the main path's shapes; CUDA-event times of
   both at the north-star shape;
4. the main path: right sweeps at max_bond 64, 128, 256, 256, 256, then
   one left sweep; each sweep must launch the kernel at least
   ncv * (L - 1) times; the final state's energy, evaluated in float64
   on the host, must lie within a relative 2e-5 of E_REF;
5. where one bulk bond's time goes, phase by phase.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import time

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
# bench's acceptance bound for a float32 state (bench.py:402)
E_REF = -56.535467821834
E_REL_TOL = 2e-5
# (w, M, K1, K2, N): the bulk bond at chi=256, a bond next to a chain
# end, and a ragged shape that leaves partial tiles on every edge
CHECK_SHAPES = ((5, 512, 512, 512, 512), (5, 4, 4, 512, 512),
                (5, 130, 66, 98, 34))
# relative Frobenius error against float64: accumulation over depths of
# 512 and 5 * 512 in the operands' own precision
KERNEL_TOLS = {torch.float32: 1e-5, torch.float64: 1e-12}


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
    print((lib.parent / "build.log").read_text(), flush=True)


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


def check_kernel():
    """Kernel vs plain version; returns (max_abs_err at the north-star
    shape in float32, kernel ms, plain ms)."""
    rng = np.random.default_rng(SEED)
    max_abs_err = None
    for shape in CHECK_SHAPES:
        w, M, K1, K2, N = shape
        host = (rng.standard_normal((w, M, K1)),
                rng.standard_normal((K1, K2)),
                rng.standard_normal((w, K2, N)))
        ref = ck.sandwich_matvec_reference(
            *(_cuda(x, torch.float64) for x in host)
        )
        for dtype, tol in KERNEL_TOLS.items():
            got = ck.sandwich_matvec(*(_cuda(x, dtype) for x in host))
            torch.cuda.synchronize()
            diff = got.double() - ref
            rel = (torch.linalg.norm(diff) / torch.linalg.norm(ref)).item()
            print(f"kernel {dtype} {shape}: relative error {rel:.3e} "
                  f"(tolerance {tol:.0e})", flush=True)
            if not rel <= tol:
                raise AssertionError(f"sandwich kernel disagrees at "
                                     f"{shape} {dtype}: {rel:.3e}")
            if shape == CHECK_SHAPES[0] and dtype == torch.float32:
                max_abs_err = diff.abs().max().item()
                args = tuple(_cuda(x, dtype) for x in host)

    # plain, kernel, kernel, plain on the same operands
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = (ck.sandwich_matvec_reference if name == "plain"
              else ck.sandwich_matvec)
        times[name].append(_event_ms(fn, args))
    w, M, K1, K2, N = CHECK_SHAPES[0]
    flop = 2 * w * (M * K1 * K2 + M * K2 * N)
    kernel_ms = statistics.mean(times["kernel"])
    plain_ms = statistics.mean(times["plain"])
    print(f"sandwich at {CHECK_SHAPES[0]} float32: kernel "
          f"{times['kernel']} ms ({flop / kernel_ms / 1e9:.2f} TFLOP/s), "
          f"plain einsum {times['plain']} ms "
          f"({flop / plain_ms / 1e9:.2f} TFLOP/s)", flush=True)
    return max_abs_err, kernel_ms, plain_ms


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


def run_main_path():
    """The DMRG2 main path; returns (dmrg, sandwich launches)."""
    H = quimb_torch.MPO_ham_heis(L, dtype=torch.float32, device="cuda")
    p0 = quimb_torch.MPS_rand_state(L, P0_BOND, seed=SEED,
                                    dtype=torch.float32, device="cuda")
    dmrg = quimb_torch.DMRG2(H, bond_dims=CHI, cutoffs=0.0, p0=p0)
    opts = dmrg.opts
    min_launches = (max(2 * opts["local_eig_ncv"],
                        opts["local_eig_ncv_floor"])
                    * opts["local_eig_restarts"] * (L - 1))
    sweeps = [("R", mb) for mb in R_SCHEDULE] + [("L", CHI)]

    torch.cuda.synchronize()
    ck.SANDWICH_LAUNCHES = 0
    t_path = time.perf_counter()
    for direction, max_bond in sweeps:
        before = ck.SANDWICH_LAUNCHES
        t0 = time.perf_counter()
        en = dmrg.sweep(direction, max_bond=max_bond, cutoff=0.0,
                        canonize=direction == "R")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        dmrg.energies.append(en)
        n = ck.SANDWICH_LAUNCHES - before
        print(f"sweep {direction} max_bond={max_bond}: {dt:.3f} s, "
              f"energy {en:.10f}, sandwich launches {n}", flush=True)
        if n < min_launches:
            raise AssertionError(f"sweep launched the kernel {n} times, "
                                 f"fewer than {min_launches}")
    launches = ck.SANDWICH_LAUNCHES
    print(f"main path: {time.perf_counter() - t_path:.3f} s, "
          f"{launches} sandwich launches", flush=True)

    for A in dmrg.state:
        if not (A.shape[0] <= CHI and A.shape[2] <= CHI
                and bool(torch.isfinite(A).all())):
            raise AssertionError(f"bad site tensor {tuple(A.shape)}")
    t0 = time.perf_counter()
    e64 = host_f64_energy(dmrg.state, dmrg._W)
    rel = abs(e64 - E_REF) / abs(E_REF)
    print(f"float64 host energy {e64:.10f} "
          f"({time.perf_counter() - t0:.1f} s): delta {e64 - E_REF:.3e}, "
          f"relative {rel:.3e} (bound {E_REL_TOL:.0e}); last sweep "
          f"energy {dmrg.energies[-1]:.10f}", flush=True)
    if not rel < E_REL_TOL:
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
    phases = {
        "local solve (operands + Lanczos + eigh)": lambda: (
            D._local_solve_2site(lenv, W1, W2, renv, theta0, **kw)),
        "  sandwich operands": lambda: D._sandwich_operands(
            lenv, W1, W2, renv),
        "  one sandwich matvec": lambda: ck.sandwich_matvec(A, th, B),
        f"  eigh {kw['ncv']}x{kw['ncv']}": lambda: torch.linalg.eigh(T),
        "split (masked SVD)": lambda: D._split_2site(theta, CHI, 0.0,
                                                     "right"),
        f"  torch.linalg.svd {tuple(mat.shape)}, gesvd": lambda: (
            torch.linalg.svd(mat, full_matrices=False, driver="gesvd")),
        "env step": lambda: D._env_step_right(lenv, torch.conj(N1), W1,
                                              N1),
    }
    print(f"bulk bond {i} (theta {tuple(theta0.shape)}, float32), "
          f"median wall ms:", flush=True)
    for name, fn in phases.items():
        print(f"  {name}: {_host_ms(fn):.3f}", flush=True)


def main():
    check_device()
    build_kernels()
    max_abs_err, kernel_ms, plain_ms = check_kernel()
    dmrg, launches = run_main_path()
    bond_breakdown(dmrg)
    print(json.dumps({"kernels": [{
        "name": "sandwich_matvec",
        "route": "cuda",
        "source": "quimb_torch/csrc/sandwich.cu",
        "replaces": "quimb_tpu/ops/pallas_kernels.py:68",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
