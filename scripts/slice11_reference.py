"""Record quimb_tpu's float64 values of the ring TEBD quench, the 16x16
norms and the FullUpdate run that ``chip_smoke.py`` holds the port to.

Three parts, each written under its name into
``scripts/slice11_reference.json`` (the other parts' entries are kept):

- ``ring_tebd``: the TEBD quench of ``chip_smoke.py``'s phase 10 (the
  Néel state, ``ham_1d_heis``, max_bond 64, cutoff 1e-10, order-4 steps
  of 0.05, the first 5 of phase 10's 20) on a ring of 64 sites
  (``cyclic=True``), complex128,
  bond by bond on the cyclic MPS: the entropy ``tebd.entropy(32)`` after
  each step and the final ``err``.
- ``peps16_norms``: the 16x16, D=3 SimpleUpdate state of
  ``scripts/peps16_reference.py`` (the same start arrays and schedule),
  scaled by :func:`unit_state`, and its norm ``<psi|psi>`` at max_bond 32
  by ``contract_boundary`` (mode ``"mps"`` and ``"full-bond"``) and
  ``contract_ctmrg``, and at max_bond 16 by ``contract_hotrg``.
- ``full_update``: FullUpdate (ALS) of ``ham_2d_heis(L, L)`` at D=3,
  chi=32 from ``start_arrays(L, 3)`` (``default_rng(42)``), 1 step at
  tau=0.3 then 1 at 0.1 (2 + 2 until phases 24-25 were added), and
  SimpleUpdate on the same schedule from the
  same start; both energies by ``compute_energy()``.

JAX runs on the CPU in float64, quimb_tpu's boundary contractions on host
arrays (``contract_backend("numpy")``). Run from the root of the
repository, one thread each::

    OMP_NUM_THREADS=1 OPENBLAS_NUM_THREADS=1 JAX_PLATFORMS=cpu \\
        XLA_FLAGS="--xla_cpu_multi_thread_eigen=false \\
        intra_op_parallelism_threads=1" \\
        python scripts/slice11_reference.py [ring_tebd] \\
        [peps16_norms [mps] [full_bond] [ctmrg] [hotrg]] [full_update [L]]

(each part, or each norm, may run in a process of its own: the file is
re-read and merged before every write).
"""

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

OUT = os.path.join(HERE, "slice11_reference.json")

RING_L, RING_CHI, RING_STEPS, RING_DT, RING_CUTOFF = 64, 64, 5, 0.05, 1e-10
PEPS_L, PEPS_D, PEPS_CHI, PEPS_NITS = 16, 3, 32, 30
# HOTRG's second merges hold tensors of chi**6 entries (8 GB at chi=32,
# more than an 80 GB card holds for a row of them): it runs at 16
HOTRG_CHI = 16
FU_D, FU_CHI, FU_SCHEDULE = 3, 32, ((1, 0.3), (1, 0.1))
PARTS = ("ring_tebd", "peps16_norms", "full_update")
NORMS = ("mps", "full_bond", "ctmrg", "hotrg")


def unit_state(psi, chi, TensorNetwork):
    """``psi`` scaled in place so that ``<psi|psi>`` is close to 1: every
    site tensor to norm 1, then all by one factor from ``log10 <psi|psi>``,
    read off the ``xmin`` boundary environment of the last row at ``chi``
    (its mantissa tensors and its ``exponent``). A 16x16 norm of unit
    tensors underflows float64; the scaled one neither underflows nor
    overflows by any method. The state's own ``exponent`` is dropped (its
    scale is irrelevant here)."""
    psi.exponent = 0.0
    for t in psi:
        t.modify(apply=lambda d: d / np.linalg.norm(d))
    norm = psi.make_norm()
    L = psi.Lx
    env = norm.compute_x_environments(max_bond=chi)["xmin", L - 1]
    last = TensorNetwork(tuple(env) + tuple(
        norm.select(norm.x_tag(L - 1), which="any")), virtual=False)
    log10 = np.log10(abs(complex(last.contract(...)))) + env.exponent
    f = 10.0 ** (-log10 / (2 * psi.num_tensors))
    for t in psi:
        t.modify(apply=lambda d: d * f)
    return psi


def ring_tebd():
    import quimb_tpu.tensor as qtn

    t0 = time.perf_counter()
    psi0 = qtn.MPS_neel_state(RING_L, cyclic=True, dtype="complex128")
    tebd = qtn.TEBD(psi0, qtn.ham_1d_heis(RING_L, cyclic=True),
                    split_opts={"max_bond": RING_CHI, "cutoff": RING_CUTOFF},
                    progbar=False)
    entropies, seconds = [], []
    for k in range(1, RING_STEPS + 1):
        ts = time.perf_counter()
        tebd.update_to(k * RING_DT, dt=RING_DT, order=4)
        entropies.append(tebd.entropy(RING_L // 2))
        seconds.append(time.perf_counter() - ts)
        print(f"ring step {k}: S {entropies[-1]!r} ({seconds[-1]:.1f} s)",
              flush=True)
    return {"L": RING_L, "chi": RING_CHI, "steps": RING_STEPS,
            "dt": RING_DT, "cutoff": RING_CUTOFF, "entropies": entropies,
            "err": float(tebd.err), "step_seconds": seconds,
            "seconds": time.perf_counter() - t0}


def peps16_norms(methods):
    import quimb_tpu.tensor as qtn
    from peps16_reference import start_arrays
    from quimb_tpu.ops.contraction import contract_backend

    t0 = time.perf_counter()
    ham = qtn.ham_2d_heis(PEPS_L, PEPS_L)
    su = qtn.SimpleUpdate(qtn.PEPS(start_arrays(PEPS_L, PEPS_D),
                                   shape="urdlp"), ham, D=PEPS_D,
                          compute_energy_every=None,
                          compute_energy_final=False)
    su.evolve(2, tau=0.3)
    for tau in (0.3, 0.1, 0.03):
        su.evolve(PEPS_NITS, tau=tau)
    psi = su.get_state()
    psi.apply_to_arrays(np.asarray)
    out = {"L": PEPS_L, "D": PEPS_D, "chi": PEPS_CHI,
           "su_seconds": time.perf_counter() - t0}
    calls = {
        "mps": lambda tn: tn.contract_boundary(max_bond=PEPS_CHI),
        "full_bond": lambda tn: tn.contract_boundary(max_bond=PEPS_CHI,
                                                     mode="full-bond"),
        "ctmrg": lambda tn: tn.contract_ctmrg(max_bond=PEPS_CHI),
        "hotrg": lambda tn: tn.contract_hotrg(max_bond=HOTRG_CHI),
    }
    with contract_backend("numpy"):
        norm = unit_state(psi, PEPS_CHI, qtn.TensorNetwork).make_norm()
        for name in methods:
            fn = calls[name]
            ts = time.perf_counter()
            out[name] = {"value": float(np.real(complex(fn(norm.copy())))),
                         "seconds": time.perf_counter() - ts}
            print(f"{name}: {out[name]}", flush=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def full_update(L):
    import quimb_tpu.tensor as qtn
    from peps16_reference import start_arrays
    from quimb_tpu.ops.contraction import contract_backend

    out = {"L": L, "D": FU_D, "chi": FU_CHI,
           "schedule": [list(s) for s in FU_SCHEDULE]}
    ham = qtn.ham_2d_heis(L, L)
    with contract_backend("numpy"):
        for name, cls, kw in (
                ("full_update", qtn.FullUpdate, {}),
                ("simple_update", qtn.SimpleUpdate,
                 {"compute_energy_every": None})):
            t0 = time.perf_counter()
            psi0 = qtn.PEPS(start_arrays(L, FU_D), shape="urdlp")
            psi0.apply_to_arrays(np.asarray)
            ev = cls(psi0, ham, D=FU_D, chi=FU_CHI,
                     compute_energy_final=False, **kw)
            energies = []
            for steps, tau in FU_SCHEDULE:
                ev.evolve(steps, tau=tau)
                energies.append(float(np.real(ev.compute_energy())))
                print(f"{name} after {steps} at {tau}: {energies[-1]!r} "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
            out[name] = {"energies": energies,
                         "seconds": time.perf_counter() - t0}
    out["gates"] = sum(s for s, _ in FU_SCHEDULE) * len(ham.terms)
    return out


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    args = sys.argv[1:] or ["ring_tebd", "peps16_norms", "full_update"]
    done = {}
    for i, part in enumerate(args):
        rest = [a for a in args[i + 1:] if a not in PARTS]
        if part == "ring_tebd":
            done[part] = ring_tebd()
        elif part == "peps16_norms":
            done[part] = peps16_norms(rest[:len(NORMS)] if rest
                                      and rest[0] in NORMS else NORMS)
        elif part == "full_update":
            done[part] = full_update(int(rest[0]) if rest
                                     and rest[0].isdigit() else 4)
        elif part in NORMS or part.isdigit():
            continue
        else:
            raise ValueError(f"unknown part {part!r}")
        # re-read before writing: parts may run in parallel processes, and
        # the norms of one run may be split over several
        now = json.load(open(OUT)) if os.path.exists(OUT) else {}
        if part == "peps16_norms":
            done[part] = {**now.get(part, {}), **done[part]}
        now[part] = done[part]
        with open(OUT, "w") as f:
            json.dump(now, f, indent=1)
        print(json.dumps({part: {k: v for k, v in done[part].items()
                                 if k != "step_seconds"}}), flush=True)


if __name__ == "__main__":
    main()
