"""Record quimb_tpu's float64 values of the 16x16 PEPS protocol.

The protocol of ``benchref/measure_tpu_peps16.py``: the Heisenberg model
``ham_2d_heis(L, L)``, a random PEPS of bond dimension D, ``SimpleUpdate``
at D with no energy during the evolution, ``evolve(2, tau=0.3)`` then
``nits`` steps at each of tau = 0.3, 0.1, 0.03, and the energy
``get_state().compute_local_expectation(ham.terms, max_bond=chi,
normalized=True)``. The start arrays are drawn from
``np.random.default_rng(42)`` with ``standard_normal``, site by site in
row-major order, in ``PEPS_rand``'s shapes (axes ``urdlp``, edge bonds
dropped), so that the port can start from the same arrays: quimb_tpu's
``PEPS.rand`` draws from JAX's generator, which torch cannot reproduce.

JAX runs on the CPU in float64. The script prints one JSON line (the
energy per site, ``compute_energy_simple()``, the gauges' sum and sum of
squares, the seconds each stage took) and writes every gauge vector, by
bond, to ``scripts/peps16_reference.json``. ``chip_smoke.py``'s phase 16
holds the port to these values. Run from the root of the repository::

    JAX_PLATFORMS=cpu python scripts/peps16_reference.py [L] [D] [chi] [nits] [out]

(``out`` names another file for the gauges, for a run at another size.)
"""

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

OUT = os.path.join(HERE, "peps16_reference.json")


def start_arrays(L, D, seed=42, phys_dim=2):
    """The start arrays: ``PEPS_rand``'s shapes (u, r, d, l, p with the
    edge bonds dropped), drawn site by site from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    arrays = []
    for i in range(L):
        row = []
        for j in range(L):
            shape = [D] * sum((i < L - 1, j < L - 1, i > 0, j > 0))
            row.append(rng.standard_normal(shape + [phys_dim]))
        arrays.append(row)
    return arrays


def gauge_table(gauges, L):
    """Every bond's gauge vector, keyed ``"i,j-k,l"`` in the order of
    the horizontal bonds row by row, then the vertical ones."""
    keys = ([((i, j), (i, j + 1)) for i in range(L) for j in range(L - 1)]
            + [((i, j), (i + 1, j)) for i in range(L - 1)
               for j in range(L)])
    return {f"{a[0]},{a[1]}-{b[0]},{b[1]}":
            [float(x) for x in np.asarray(gauges[(a, b)])]
            for a, b in keys}


def main():
    L = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    D = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    chi = int(sys.argv[3]) if len(sys.argv) > 3 else 32
    nits = int(sys.argv[4]) if len(sys.argv) > 4 else 30
    out = sys.argv[5] if len(sys.argv) > 5 else OUT

    import jax

    jax.config.update("jax_enable_x64", True)
    import quimb_tpu.tensor as qtn

    t_all = time.perf_counter()
    psi0 = qtn.PEPS(start_arrays(L, D), shape="urdlp")
    ham = qtn.ham_2d_heis(L, L)
    su = qtn.SimpleUpdate(psi0, ham, D=D, compute_energy_every=None,
                          compute_energy_final=False)
    t0 = time.perf_counter()
    su.evolve(2, tau=0.3)
    for tau in (0.3, 0.1, 0.03):
        su.evolve(nits, tau=tau)
    su_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    e_simple = su.compute_energy_simple()
    simple_s = time.perf_counter() - t0
    gauges = gauge_table(su.gauges, L)
    psi = su.get_state()
    t0 = time.perf_counter()
    e = psi.compute_local_expectation(ham.terms, max_bond=chi,
                                      normalized=True)
    energy_s = time.perf_counter() - t0
    g = np.array([x for v in gauges.values() for x in v])
    result = {
        "L": L, "D": D, "chi": chi, "steps": 2 + 3 * nits,
        "dtype": str(np.asarray(su.gauges[((0, 0), (0, 1))]).dtype),
        "energy_per_site": float(np.real(e)) / (L * L),
        "energy_simple": float(e_simple),
        "gauge_count": len(gauges),
        "gauge_sum": float(g.sum()),
        "gauge_sum_sq": float((g ** 2).sum()),
        "su_seconds": su_s,
        "energy_simple_seconds": simple_s,
        "energy_seconds": energy_s,
        "total_seconds": time.perf_counter() - t_all,
    }
    with open(out, "w") as f:
        json.dump({**result, "gauges": gauges}, f, indent=0)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
