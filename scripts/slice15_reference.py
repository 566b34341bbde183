"""Record quimb_tpu's float64 values of the matrix-half phases that
``chip_smoke.py`` holds the port to (phases 26 and 27).

Three parts, each written under its name into
``scripts/slice15_reference.json`` (the other parts' entries are kept):

- ``ed``: phase 26. The spin-1/2 Heisenberg antiferromagnet
  (``heisenberg_from_edges``) on the 4 x 4 and 4 x 6 tori
  (``edges_2d_square(Lx, Ly, cyclic=True)``) in the U1 sector of half
  filling, by quimb_tpu's ``build_sparse_matrix`` and scipy's ``eigsh``
  (``which="SA"``, ``tol=1e-12``, start ``default_rng(42)``): the sector
  size, the terms, the nonzeros, the ground energy, the seconds of the
  build and of the solve, and the peak resident memory of the process.
- ``dense``: phase 27's N=20 quantities. The ground state of
  ``ham_heis(20, sparse=True)`` (scipy's ``eigsh`` at ``tol=0``, machine
  precision, start ``default_rng(42)``), then quimb_tpu's
  ``entropy_subsys`` of sites 0-9, ``mutinf_subsys`` of 0-4 and 10-14,
  ``logneg_subsys`` of 4-9 and 10-15, ``schmidt_gap`` of 0-9, and
  ``concurrence`` and ``pauli_correlations`` of the reduced state of sites
  9 and 10; and quimb_tpu's ``Evolution(..., method="integrate")`` of the
  Neel state '0101...' under the same Hamiltonian, <Z_0> at t = 1/4, 1/2,
  3/4, 1 (phase 11's protocol).
- ``lindblad``: phase 27's N=10 density operator. The Neel state's density
  operator under ``ham_heis(10)`` with dephasing ``Z_i`` on every site at
  gamma = 0.1, by quimb_tpu's ``Evolution(p0, (H, ls, gamma),
  method="integrate")`` to t = 1: <Z_i> of every site and the purity; and
  without dissipation by ``method="solve"`` to t = 1: <Z_i>, the purity
  and the diagonal of rho(t).

JAX runs on the CPU in float64. Run from the root of the repository::

    JAX_PLATFORMS=cpu python scripts/slice15_reference.py [ed] [dense] \\
        [lindblad]

(each part may run in a process of its own: the file is re-read and
merged before every write).
"""

import json
import os
import resource
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

OUT = os.path.join(HERE, "slice15_reference.json")
PARTS = ("ed", "dense", "lindblad")

TORI = ((4, 4), (4, 6))
EIGSH_TOL, SEED = 1e-12, 42
DENSE_N, EXACT_T, EXACT_NT = 20, 1.0, 4
ENT_SITES = tuple(range(10))
MUTINF_SITES = (tuple(range(0, 5)), tuple(range(10, 15)))
LOGNEG_SITES = (tuple(range(4, 10)), tuple(range(10, 16)))
PAIR = (9, 10)
LINDBLAD_N, GAMMA, LINDBLAD_T = 10, 0.1, 1.0


def _peak_gb():
    """The process's peak resident memory (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def ed():
    import scipy.sparse.linalg as spla

    from quimb_tpu.operator import HilbertSpace, heisenberg_from_edges
    from quimb_tpu.tensor.geometry import edges_2d_square

    out = {}
    for Lx, Ly in TORI:
        edges = edges_2d_square(Lx, Ly, cyclic=True)
        sites = sorted({s for e in edges for s in e})
        n = len(sites)
        hs = HilbertSpace(sites, symmetry="U1", sector=n // 2)
        b = heisenberg_from_edges(edges, hilbert_space=hs)
        t0 = time.perf_counter()
        H = b.build_sparse_matrix()
        build_s = time.perf_counter() - t0
        v0 = np.random.default_rng(SEED).standard_normal(H.shape[0])
        t0 = time.perf_counter()
        w = spla.eigsh(H, k=1, which="SA", tol=EIGSH_TOL, v0=v0,
                       return_eigenvectors=False)
        solve_s = time.perf_counter() - t0
        out[f"{Lx}x{Ly}"] = {
            "edges": len(edges), "terms": b.nterms, "D": int(H.shape[0]),
            "nnz": int(H.nnz), "energy": float(w[0]),
            "build_s": build_s, "solve_s": solve_s,
            "peak_rss_gb": _peak_gb(),
        }
        print(json.dumps({f"{Lx}x{Ly}": out[f"{Lx}x{Ly}"]}), flush=True)
        del H
    return out


def ground_state(n):
    """The ground state of ``ham_heis(n)`` to machine precision, and its
    energy, from scipy's ``eigsh`` on quimb_tpu's sparse matrix."""
    import scipy.sparse.linalg as spla

    import quimb_tpu.gen.operators as jops

    H = jops.ham_heis(n, sparse=True)
    v0 = np.random.default_rng(SEED).standard_normal(H.shape[0])
    w, v = spla.eigsh(H.real, k=1, which="SA", tol=0, v0=v0)
    return H, float(w[0]), v[:, 0]


def dense():
    import jax.numpy as jnp

    import quimb_tpu.calc as jcalc
    import quimb_tpu.core as jcore
    import quimb_tpu.evo as jevo
    import quimb_tpu.gen.states as jstates

    n = DENSE_N
    dims = (2,) * n
    t0 = time.perf_counter()
    H, e0, psi = ground_state(n)
    out = {"energy": e0, "ground_state_s": time.perf_counter() - t0}
    psi = jnp.asarray(psi.reshape(-1, 1))
    t0 = time.perf_counter()
    out["entropy_subsys"] = float(jcalc.entropy_subsys(psi, dims,
                                                       ENT_SITES))
    out["mutinf_subsys"] = float(jcalc.mutinf_subsys(psi, dims,
                                                     *MUTINF_SITES))
    out["logneg_subsys"] = float(jcalc.logneg_subsys(psi, dims,
                                                     *LOGNEG_SITES))
    out["schmidt_gap"] = float(jcalc.schmidt_gap(psi, dims, ENT_SITES))
    rho2 = jcore.ptr(psi, dims, PAIR)
    out["concurrence"] = float(jcalc.concurrence(rho2))
    out["pauli_correlations"] = [float(c) for c in
                                 jcalc.pauli_correlations(rho2, sysa=0,
                                                          sysb=1)]
    out["calc_s"] = time.perf_counter() - t0

    p0 = jstates.computational_state("01" * (n // 2))
    bit0 = (np.arange(2**n) >> (n - 1)) & 1
    zdiag = 1 - 2 * bit0
    evo = jevo.Evolution(p0, H, method="integrate")
    zs = []
    t0 = time.perf_counter()
    for k in range(1, EXACT_NT + 1):
        evo.update_to(EXACT_T * k / EXACT_NT)
        p = np.abs(np.asarray(evo.pt).reshape(-1)) ** 2
        zs.append(float(np.sum(p * zdiag) / np.sum(p)))
    out["integrate_z0"] = zs
    out["integrate_s"] = time.perf_counter() - t0
    return out


def _z_all(rho, n):
    """<Z_i> of every site of the density operator ``rho``."""
    p = np.real(np.diag(np.asarray(rho)))
    idx = np.arange(2**n)
    return [float(np.sum(p * (1 - 2 * ((idx >> (n - 1 - i)) & 1))))
            for i in range(n)]


def lindblad():
    import jax.numpy as jnp

    import quimb_tpu.core as jcore
    import quimb_tpu.evo as jevo
    import quimb_tpu.gen.operators as jops
    import quimb_tpu.gen.states as jstates

    n = LINDBLAD_N
    dims = (2,) * n
    H = jops.ham_heis(n)
    ls = [jcore.ikron(np.asarray(jops.pauli("Z")), dims, i)
          for i in range(n)]
    p0 = jcore.dop(jstates.computational_state("01" * (n // 2)))
    out = {}
    t0 = time.perf_counter()
    evo = jevo.Evolution(p0, (H, ls, GAMMA), method="integrate")
    evo.update_to(LINDBLAD_T)
    rho = np.asarray(evo.pt)
    out["lindblad_s"] = time.perf_counter() - t0
    out["lindblad_z"] = _z_all(rho, n)
    out["lindblad_purity"] = float(np.real(np.sum(rho * rho.T)))
    out["lindblad_trace"] = float(np.real(np.trace(rho)))
    t0 = time.perf_counter()
    evo = jevo.Evolution(p0, H, method="solve")
    evo.update_to(LINDBLAD_T)
    rho = np.asarray(evo.pt)
    out["solve_s"] = time.perf_counter() - t0
    out["solve_z"] = _z_all(rho, n)
    out["solve_purity"] = float(np.real(np.sum(rho * rho.T)))
    out["solve_diag"] = [float(x) for x in np.real(np.diag(rho))]
    return out


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    for part in sys.argv[1:] or PARTS:
        if part not in PARTS:
            raise ValueError(f"unknown part {part!r}")
        done = globals()[part]()
        now = json.load(open(OUT)) if os.path.exists(OUT) else {}
        now[part] = done
        with open(OUT, "w") as f:
            json.dump(now, f, indent=1)
        print(json.dumps({part: {k: v for k, v in done.items()
                                 if k != "solve_diag"}}), flush=True)


if __name__ == "__main__":
    main()
