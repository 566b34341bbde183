"""Record quimb_tpu's float64 values of the arbitrary-geometry phases that
``chip_smoke.py`` holds the port to (phase 21).

Three parts, each written under its name into
``scripts/slice12_reference.json`` (the other parts' entries are kept):

- ``kagome``: ``SimpleUpdateGen`` of the Heisenberg antiferromagnet
  (``ham_gen_heis``) on the open 6 x 6 kagome lattice
  (``edges_2d_kagome(6, 6)``, 108 sites) at D=4 in float64, from start
  arrays drawn site by site from ``np.random.default_rng(42)`` through
  ``TN_from_edges_and_fill_fn`` (:func:`kagome_fill`), ten steps at each
  of tau = 0.3, 0.1, 0.03; the energy per site by
  ``compute_local_expectation(method="cluster")``.
- ``compress``: the 16x16, D=3 SimpleUpdate state of
  ``scripts/peps16_reference.py``, scaled by :func:`unit_state`; the
  direct sum ``phi = psi.add_PEPS(psi)`` (D=6) compressed by
  ``tensor_network_2d_compress`` with the methods ``"local-early"`` and
  ``"superorthogonal"`` to ``max_bond`` 3, and ``psi`` itself to
  ``max_bond`` 2; each result's normalised overlap with ``psi``,
  ``|<c|psi>| / (|c| |psi|)``, by ``contract_boundary`` at max_bond 32
  (:func:`fidelity`).
- ``circuit_pepo``: the 4x4, depth-4 random circuit of ``chip_smoke.py``'s
  phase 16 (:func:`cpeps_gates`) through ``CircuitPEPOSimpleUpdate``:
  <Z_q> of every qubit at the smallest ``max_bond`` (from 2 up) at which
  all sixteen lie within 1e-10 of ``Circuit.local_expectation``.

JAX runs on the CPU in float64, quimb_tpu's contractions of the 16x16
networks on host arrays (``contract_backend("numpy")``). Run from the
root of the repository, one thread each::

    OMP_NUM_THREADS=1 OPENBLAS_NUM_THREADS=1 JAX_PLATFORMS=cpu \\
        XLA_FLAGS="--xla_cpu_multi_thread_eigen=false \\
        intra_op_parallelism_threads=1" \\
        python scripts/slice12_reference.py [kagome] [compress] [circuit_pepo]

(each part may run in a process of its own: the file is re-read and
merged before every write).
"""

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

OUT = os.path.join(HERE, "slice12_reference.json")

KAGOME_L, KAGOME_D, KAGOME_NITS, KAGOME_TAUS = 6, 4, 10, (0.3, 0.1, 0.03)
PEPS_L, PEPS_D, PEPS_CHI, PEPS_NITS = 16, 3, 32, 30
COMPRESS_METHODS = ("local-early", "superorthogonal")
COMPRESS_CASES = (("phi", 3), ("psi", 2))
CPEPS_L, CPEPS_DEPTH, CPEPS_SEED, CPEPO_TOL = 4, 4, 7, 1e-10
PARTS = ("kagome", "compress", "circuit_pepo")


def kagome_fill(seed=42):
    """The fill function of the kagome start state: standard normal arrays
    from ``default_rng(seed)``, drawn in the order the builder asks."""
    rng = np.random.default_rng(seed)
    return lambda shape: rng.standard_normal(shape)


def cpeps_gates(L=CPEPS_L, depth=CPEPS_DEPTH, seed=CPEPS_SEED):
    """The gates of ``chip_smoke.py``'s 4x4 circuit: per layer a U3 of
    seeded angles on every qubit, then CZ on every horizontal and vertical
    bond in four classes. Returns the gates and the generator, as the
    phase draws its bitstrings from it next."""
    rng = np.random.default_rng(seed)
    n = L * L
    pairs = [[], [], [], []]  # horizontal even / odd, vertical even / odd
    for i in range(L):
        for j in range(L):
            q = i * L + j
            if j + 1 < L:
                pairs[j % 2].append((q, q + 1))
            if i + 1 < L:
                pairs[2 + i % 2].append((q, q + L))
    gates = []
    for _ in range(depth):
        gates += [("U3", *rng.uniform(0, 2 * np.pi, 3), q) for q in range(n)]
        gates += [("CZ", *pq) for cls in pairs for pq in cls]
    return gates, rng


def fidelity(c, psi, psi_norm, chi):
    """``|<c|psi>| / (|c| |psi|)`` of two PEPS of one lattice by the
    boundary method at ``chi``, ``psi_norm`` being ``<psi|psi>``. Each site
    tensor of ``c`` is first scaled (in place) to the norm of ``psi``'s at
    that site: ``psi`` is unit-scaled, so no norm over- or underflows, and
    the ratio does not depend on the scale."""
    for site in psi.site_tags:
        (tc,), (tp,) = c.select_tensors(site), psi.select_tensors(site)
        f = np.linalg.norm(np.asarray(tp.data)) / np.linalg.norm(
            np.asarray(tc.data))
        tc.modify(apply=lambda d, f=f: d * f)
    cp = complex(psi.make_overlap(c).view_like_(psi).contract_boundary(
        max_bond=chi))
    cc = complex(c.make_norm().contract_boundary(max_bond=chi))
    return abs(cp) / np.sqrt(abs(cc) * abs(psi_norm))


def kagome():
    import quimb_tpu.tensor as qtn

    t0 = time.perf_counter()
    edges = qtn.edges_2d_kagome(KAGOME_L, KAGOME_L)
    psi0 = qtn.TN_from_edges_and_fill_fn(kagome_fill(), edges, KAGOME_D,
                                         phys_dim=2)
    ham = qtn.ham_gen_heis(edges)
    su = qtn.SimpleUpdateGen(psi0, ham, D=KAGOME_D,
                             compute_energy_final=False)
    for tau in KAGOME_TAUS:
        su.evolve(KAGOME_NITS, tau=tau)
        print(f"kagome: {KAGOME_NITS} steps at {tau} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t_su = time.perf_counter() - t0
    e = su.get_state().compute_local_expectation(ham.terms, method="cluster")
    nsites = psi0.nsites
    return {"L": KAGOME_L, "D": KAGOME_D, "nits": KAGOME_NITS,
            "taus": list(KAGOME_TAUS), "sites": nsites,
            "bonds": len(edges), "energy_per_site": float(np.real(e)) / nsites,
            "su_seconds": t_su, "seconds": time.perf_counter() - t0}


def compress():
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
    TN = qtn.TensorNetwork
    with contract_backend("numpy"):
        from slice11_reference import unit_state

        unit_state(psi, PEPS_CHI, TN)
        psi_norm = complex(psi.make_norm().contract_boundary(
            max_bond=PEPS_CHI))
        out["psi_norm"] = psi_norm.real
        phi = psi.add_PEPS(psi)
        for method in COMPRESS_METHODS:
            for which, mb in COMPRESS_CASES:
                ts = time.perf_counter()
                src = phi if which == "phi" else psi
                c = qtn.tensor_network_2d_compress(src, max_bond=mb,
                                                   method=method)
                secs = time.perf_counter() - ts
                f = fidelity(c, psi, psi_norm, PEPS_CHI)
                out[f"{method} {which} {mb}"] = {
                    "fidelity": f, "compress_seconds": secs,
                    "max_bond": c.max_bond()}
                print(f"{method} {which} -> {mb}: fidelity {f!r} "
                      f"({secs:.1f} s)", flush=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def circuit_pepo():
    import quimb_tpu.tensor as qtn

    t0 = time.perf_counter()
    gates, _ = cpeps_gates()
    n = CPEPS_L * CPEPS_L
    Z = np.diag([1.0, -1.0])
    exact = qtn.Circuit(N=n)
    exact.apply_gates(gates)
    want = [complex(exact.local_expectation(Z, q)).real for q in range(n)]
    for mb in range(2, 65):
        cp = qtn.CircuitPEPOSimpleUpdate(N=n, max_bond=mb)
        cp.apply_gates(gates)
        got = [complex(cp.local_expectation(Z, q)).real for q in range(n)]
        dist = max(abs(a - b) for a, b in zip(got, want))
        print(f"max_bond {mb}: largest distance from Circuit {dist:.3e} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if dist <= CPEPO_TOL:
            break
    return {"L": CPEPS_L, "depth": CPEPS_DEPTH, "seed": CPEPS_SEED,
            "max_bond": mb, "z": got, "circuit_z": want, "distance": dist,
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
        print(json.dumps({part: done}), flush=True)


if __name__ == "__main__":
    main()
