"""Record quimb_tpu's float64 values of the 3D and belief-propagation
phases that ``chip_smoke.py`` holds the port to (phases 22-23), and of the
kagome cluster energy of phase 21(a) with its gauging capped.

Five parts, each written under its name into
``scripts/slice13_reference.json`` (the other parts' entries are kept):

- ``ising3d``: the 3D classical Ising model at its critical coupling
  (``TN3D_classical_ising_partition_function(L, L, L, beta=0.2216544)``):
  the exact contraction at 3 x 3 x 3, ``contract_ctmrg(max_bond=16)`` at
  L=8, ``contract_boundary(max_bond=12)`` and ``contract_hotrg(max_bond=8)``
  at L=6; each log Z (natural log) and its seconds; and the site tensor
  norms of ``gauge_all_belief_propagation()`` of the L=6 network.
- ``peps3d``: a 4 x 4 x 4 ``PEPS3D`` at D=3 from ``PEPS3D.from_fill_fn``
  with standard normal arrays from ``np.random.default_rng(42)``, evolved
  by ``SimpleUpdate3D`` with ``ham_3d_heis(4, 4, 4)`` for two steps at
  each of tau = 0.3, 0.1, 0.03 (five until phases 24-25 were added); the 144 gauge vectors (keyed by their two
  sites), and the BP energy of ``get_state()``: ``D2BP`` run to its
  default tolerance, then ``local_expectation`` of the Heisenberg term on
  each bond, summed.
- ``peps16_bp``: the 16 x 16, D=3 SimpleUpdate state of
  ``scripts/peps16_reference.py`` (``get_state()``, as ``chip_smoke.py``'s
  phase 16 returns it): ``D2BP`` run to its default tolerance, its
  ``contract`` (mantissa and exponent), the BP energy of the 480
  Heisenberg bonds by ``local_expectation``, the site tensor norms of
  ``compress_d2bp(psi, max_bond=2)`` warm-started from the converged
  messages, and the 1-norm ``D1BP`` that ``gauge_all_belief_propagation``
  runs (it does not converge on this signed state).
- ``hyper``: the 3D Ising model with a field in hyper form
  (``HTN3D_classical_ising_partition_function(L, L, L, beta=0.2216544,
  h=0.1)``) by ``contract_hv1bp`` at L=8 and by ``contract_hd1bp`` and
  ``contract_hv1bp`` at L=4, and random 3-SAT counting
  (``HTN_random_ksat(3, 1000, alpha=3.0, seed=7)``) by ``contract_hv1bp``:
  each estimate's log10, its iterations and seconds.
- ``kagome``: phase 21(a)'s protocol (``scripts/slice12_reference.py``'s
  ``kagome``) at one step a tau (five until phases 24-25 were added, two
  until phases 26-28 were) with
  the cluster energy's simple gauging capped at 20 iterations: ``gauge_all_simple(max_iterations=20)``, then
  ``compute_local_expectation(method="cluster", gauges=...)``.

JAX runs on the CPU in float64, quimb_tpu's contractions on host arrays
(``contract_backend("numpy")``) where its networks allow. Run from the
root of the repository, one thread each::

    OMP_NUM_THREADS=1 OPENBLAS_NUM_THREADS=1 JAX_PLATFORMS=cpu \\
        XLA_FLAGS="--xla_cpu_multi_thread_eigen=false \\
        intra_op_parallelism_threads=1" \\
        python scripts/slice13_reference.py [ising3d] [peps3d] [peps16_bp] \\
        [hyper] [kagome]

(each part may run in a process of its own: the file is re-read and
merged before every write).
"""

import json
import math
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

OUT = os.path.join(HERE, "slice13_reference.json")

BETA_C = 0.2216544
ISING_EXACT_L = 3
ISING_RUNS = (("ctmrg", 8, 16), ("boundary", 6, 12), ("hotrg", 6, 8))
ISING_GAUGE_L = 6
P3D_L, P3D_D, P3D_NITS, P3D_TAUS, P3D_SEED = 4, 3, 2, (0.3, 0.1, 0.03), 42
PEPS_L, PEPS_D, PEPS_NITS = 16, 3, 30
BP_MAX_BOND = 2
HYPER_H, HYPER_L, HYPER_L_D1 = 0.1, 8, 4
KSAT = dict(k=3, num_variables=1000, alpha=3.0, seed=7)
KAGOME_L, KAGOME_D, KAGOME_NITS, KAGOME_TAUS = 6, 4, 1, (0.3, 0.1, 0.03)
KAGOME_GAUGE_ITERATIONS = 20
PARTS = ("ising3d", "peps3d", "peps16_bp", "hyper", "kagome")


def ising_log_z(tn, method, chi):
    """The natural log of the 3D Ising network's value by ``method``."""
    if method == "exact":
        z = tn.contract(...)
    elif method == "ctmrg":
        z = tn.contract_ctmrg(max_bond=chi)
    elif method == "boundary":
        z = tn.contract_boundary(max_bond=chi)
    else:
        z = tn.contract_hotrg(max_bond=chi)
    return math.log(abs(complex(z))) + tn.exponent * math.log(10)


def site_key(coo_a, coo_b):
    return "|".join(",".join(map(str, c)) for c in (coo_a, coo_b))


def bond_sites(psi, ix):
    """The two site coordinates of a PEPS3D bond index."""
    coos = []
    for tid in psi.ind_map[ix]:
        tag = next(t for t in psi.tensor_map[tid].tags
                   if t.startswith("I"))
        coos.append(tuple(int(v) for v in tag[1:].split(",")))
    return tuple(sorted(coos))


def heis_h2():
    s = {"x": np.array([[0, 1], [1, 0]]) / 2,
         "y": np.array([[0, -1j], [1j, 0]]) / 2,
         "z": np.array([[1, 0], [0, -1]]) / 2}
    return sum(np.kron(s[a], s[a]) for a in "xyz").real


def ising3d():
    import quimb_tpu.tensor as qtn
    from quimb_tpu.ops.contraction import contract_backend

    out = {"beta": BETA_C}
    t0 = time.perf_counter()
    with contract_backend("numpy"):
        for method, L, chi in (("exact", ISING_EXACT_L, None),
                               *ISING_RUNS):
            tn = qtn.TN3D_classical_ising_partition_function(
                L, L, L, beta=BETA_C)
            tn.apply_to_arrays(np.asarray)
            ts = time.perf_counter()
            logz = ising_log_z(tn, method, chi)
            secs = time.perf_counter() - ts
            out[f"{method} {L} {chi}"] = {"log_z": logz, "seconds": secs,
                                         "log_z_per_site": logz / L**3}
            print(f"{method} L={L} chi={chi}: log Z {logz!r} "
                  f"({secs:.1f} s)", flush=True)
        # the BP gauge of the positive L=6 network, where 1-norm BP
        # converges: its site tensors' norms
        L = ISING_GAUGE_L
        tn = qtn.TN3D_classical_ising_partition_function(L, L, L,
                                                         beta=BETA_C)
        tn.apply_to_arrays(np.asarray)
        ts = time.perf_counter()
        g = tn.gauge_all_belief_propagation()
        out[f"bp_gauge {L}"] = {
            "seconds": time.perf_counter() - ts,
            "norms": {tn.site_tag(*c): float(np.linalg.norm(
                np.asarray(g[tn.site_tag(*c)].data)))
                for c in tn.gen_site_coos()}}
    out["seconds"] = time.perf_counter() - t0
    return out


def peps3d():
    import quimb_tpu.tensor as qtn
    from quimb_tpu.ops.contraction import contract_backend
    from quimb_tpu.tensor.belief_propagation import D2BP

    t0 = time.perf_counter()
    rng = np.random.default_rng(P3D_SEED)
    L = P3D_L
    psi0 = qtn.PEPS3D.from_fill_fn(lambda s: rng.standard_normal(s),
                                   L, L, L, P3D_D)
    ham = qtn.ham_3d_heis(L, L, L)
    su = qtn.SimpleUpdate3D(psi0, ham, D=P3D_D)
    for tau in P3D_TAUS:
        su.evolve(P3D_NITS, tau)
        print(f"peps3d: {P3D_NITS} steps at {tau} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t_su = time.perf_counter() - t0
    gauges = {site_key(*bond_sites(su.state, ix)): np.asarray(s).tolist()
              for ix, s in su.gauges.items()}
    psi = su.get_state()
    psi.apply_to_arrays(np.asarray)
    h2 = heis_h2()
    with contract_backend("numpy"):
        ts = time.perf_counter()
        bp = D2BP(psi)
        bp.run()
        e = sum(bp.local_expectation(h2, where) for where in ham.terms)
        t_bp = time.perf_counter() - ts
    print(f"peps3d: BP energy {e!r}, {bp.n_iter} iterations "
          f"({t_bp:.1f} s)", flush=True)
    return {"L": L, "D": P3D_D, "nits": P3D_NITS, "taus": list(P3D_TAUS),
            "seed": P3D_SEED, "bonds": len(ham.terms), "gauges": gauges,
            "bp_energy": complex(e).real, "bp_iterations": bp.n_iter,
            "su_seconds": t_su, "bp_seconds": t_bp,
            "seconds": time.perf_counter() - t0}


def peps16_bp():
    import quimb_tpu.tensor as qtn
    from peps16_reference import start_arrays
    from quimb_tpu.ops.contraction import contract_backend
    from quimb_tpu.tensor.belief_propagation import (
        D1BP,
        D2BP,
        compress_d2bp,
    )

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
    out = {"L": PEPS_L, "D": PEPS_D, "su_seconds": time.perf_counter() - t0}
    h2 = heis_h2()
    with contract_backend("numpy"):
        ts = time.perf_counter()
        bp = D2BP(psi)
        bp.run()
        m, e = bp.contract(strip_exponent=True)
        out["bp_iterations"] = bp.n_iter
        out["bp_seconds"] = time.perf_counter() - ts
        out["log10_norm"] = e + math.log10(abs(complex(m)))
        ts = time.perf_counter()
        energy = sum(bp.local_expectation(h2, where) for where in ham.terms)
        out["energy_seconds"] = time.perf_counter() - ts
        out["bp_energy"] = complex(energy).real
        print(f"peps16: BP {bp.n_iter} iterations, log10 <psi|psi> "
              f"{out['log10_norm']!r}, energy {out['bp_energy']!r}",
              flush=True)
        ts = time.perf_counter()
        c = compress_d2bp(psi, max_bond=BP_MAX_BOND,
                          messages=dict(bp.messages))
        out["compress_seconds"] = time.perf_counter() - ts
        out["compress_norms"] = {
            t: float(np.linalg.norm(np.asarray(c[t].data)))
            for t in psi.site_tags}
        out["compress_max_bond"] = c.max_bond()
        # the 1-norm BP that gauge_all_belief_propagation runs: on this
        # signed state it does not converge, its messages still changing
        # by ~2 after its 100 iterations, so its gauge is rounding noise
        ts = time.perf_counter()
        d1 = D1BP(psi, max_iterations=100)
        d1.run()
        out["d1bp"] = {"iterations": d1.n_iter, "converged": d1.converged,
                       "last_mdiffs": d1.mdiffs[-3:],
                       "seconds": time.perf_counter() - ts}
    out["seconds"] = time.perf_counter() - t0
    return out


def hyper():
    import quimb_tpu.tensor as qtn
    from quimb_tpu.ops.contraction import contract_backend
    from quimb_tpu.tensor.belief_propagation import D1BP, HV1BP

    out = {"beta": BETA_C, "h": HYPER_H, "ksat": KSAT}
    nets = {
        f"hv1bp ising {HYPER_L}": (HV1BP, lambda:
            qtn.HTN3D_classical_ising_partition_function(
                HYPER_L, HYPER_L, HYPER_L, beta=BETA_C, h=HYPER_H)),
        f"hd1bp ising {HYPER_L_D1}": (D1BP, lambda:
            qtn.HTN3D_classical_ising_partition_function(
                HYPER_L_D1, HYPER_L_D1, HYPER_L_D1, beta=BETA_C,
                h=HYPER_H)),
        f"hv1bp ising {HYPER_L_D1}": (HV1BP, lambda:
            qtn.HTN3D_classical_ising_partition_function(
                HYPER_L_D1, HYPER_L_D1, HYPER_L_D1, beta=BETA_C,
                h=HYPER_H)),
        "hv1bp ksat": (HV1BP, lambda: qtn.HTN_random_ksat(**KSAT)),
    }
    with contract_backend("numpy"):
        for name, (engine, build) in nets.items():
            tn = build()
            tn.apply_to_arrays(np.asarray)
            ts = time.perf_counter()
            bp = engine(tn)
            bp.run()
            m, e = bp.contract(strip_exponent=True)
            secs = time.perf_counter() - ts
            out[name] = {"log10": e + math.log10(abs(complex(m))),
                         "iterations": bp.n_iter, "seconds": secs,
                         "tensors": tn.num_tensors, "indices": tn.num_indices}
            print(f"{name}: {out[name]}", flush=True)
    return out


def kagome():
    import quimb_tpu.tensor as qtn

    t0 = time.perf_counter()
    edges = qtn.edges_2d_kagome(KAGOME_L, KAGOME_L)
    rng = np.random.default_rng(42)
    psi0 = qtn.TN_from_edges_and_fill_fn(
        lambda shape: rng.standard_normal(shape), edges, KAGOME_D,
        phys_dim=2)
    ham = qtn.ham_gen_heis(edges)
    su = qtn.SimpleUpdateGen(psi0, ham, D=KAGOME_D,
                             compute_energy_final=False)
    for tau in KAGOME_TAUS:
        su.evolve(KAGOME_NITS, tau=tau)
    t_su = time.perf_counter() - t0
    ts = time.perf_counter()
    gauges = {}
    tn = su.get_state().gauge_all_simple(
        max_iterations=KAGOME_GAUGE_ITERATIONS, gauges=gauges)
    e = tn.compute_local_expectation(ham.terms, method="cluster",
                                     gauges=gauges)
    nsites = psi0.nsites
    return {"L": KAGOME_L, "D": KAGOME_D, "nits": KAGOME_NITS,
            "taus": list(KAGOME_TAUS),
            "gauge_iterations": KAGOME_GAUGE_ITERATIONS, "sites": nsites,
            "bonds": len(edges), "energy_per_site": float(np.real(e)) / nsites,
            "su_seconds": t_su, "energy_seconds": time.perf_counter() - ts,
            "seconds": time.perf_counter() - t0}


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    for part in sys.argv[1:] or PARTS:
        if part not in PARTS:
            raise ValueError(f"unknown part {part!r}")
        done = globals()[part]()
        # re-read before writing: parts may run in parallel processes
        now = json.load(open(OUT)) if os.path.exists(OUT) else {}
        now[part] = done
        with open(OUT, "w") as f:
            json.dump(now, f, indent=1)
        print(json.dumps({part: {k: v for k, v in done.items()
                                 if k not in ("gauges", "compress_norms")}
                                 }), flush=True)


if __name__ == "__main__":
    main()
