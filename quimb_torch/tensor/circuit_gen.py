"""Circuit ansatz generators (reference ``quimb/tensor/circuit_gen.py``:
``circ_ansatz_1D_zigzag``, ``circ_ansatz_1D_brickwork``,
``circ_ansatz_1D_rand``, ``circ_qaoa``, ``circ_a2a_rand``).

Port of quimb_tpu's ``tensor/circuit_gen.py`` on the port's ``Circuit``
(``device`` passes through the circuit options). The gate parameters come
from ``np.random.default_rng(seed)`` as in quimb_tpu, so both packages
build the same circuits."""

import itertools

import numpy as np

from .circuit import Circuit


def _apply_su4_layer(circ, pairs, params, parametrize=False):
    for (i, j), p in zip(pairs, params):
        circ.su4(*p, i, j)


def _param_gen(n_params, seed=None):
    rng = np.random.default_rng(seed)
    while True:
        yield rng.uniform(0, 2 * np.pi, n_params)


def circ_ansatz_1D_zigzag(n, depth, gate2="su4", seed=None,
                          circuit_opts=None, **kwargs):
    """Zig-zag 1D ansatz circuit (reference circuit_gen.py)."""
    circ = Circuit(n, **(circuit_opts or {}))
    rng = np.random.default_rng(seed)
    for d in range(depth):
        rng_pairs = (
            [(i, i + 1) for i in range(0, n - 1)]
            if d % 2 == 0 else
            [(i, i + 1) for i in range(n - 2, -1, -1)]
        )
        for (i, j) in rng_pairs:
            circ.su4(*rng.uniform(0, 2 * np.pi, 15), i, j,
                     gate_round=d)
    return circ


def circ_ansatz_1D_brickwork(n, depth, cyclic=False, gate2="su4",
                             seed=None, **circuit_opts):
    """Brickwork pattern 1D ansatz (reference circuit_gen.py)."""
    circ = Circuit(n, **circuit_opts)
    rng = np.random.default_rng(seed)
    for d in range(depth):
        start = d % 2
        pairs = [(i, i + 1) for i in range(start, n - 1, 2)]
        if cyclic and start == 1 and n % 2 == 0:
            pairs.append((n - 1, 0))
        for (i, j) in pairs:
            circ.su4(*rng.uniform(0, 2 * np.pi, 15), i, j,
                     gate_round=d)
    return circ


def circ_ansatz_1D_rand(n, depth, seed=None, **circuit_opts):
    """Random placement 1D ansatz."""
    circ = Circuit(n, **circuit_opts)
    rng = np.random.default_rng(seed)
    for d in range(depth):
        i = int(rng.integers(0, n - 1))
        circ.su4(*rng.uniform(0, 2 * np.pi, 15), i, i + 1,
                 gate_round=d)
    return circ


def circ_a2a_rand(n, depth, seed=None, gate2="su4", **circuit_opts):
    """All-to-all random two-qubit gate circuit."""
    circ = Circuit(n, **circuit_opts)
    rng = np.random.default_rng(seed)
    for d in range(depth):
        i, j = rng.choice(n, size=2, replace=False)
        circ.su4(*rng.uniform(0, 2 * np.pi, 15), int(i), int(j),
                 gate_round=d)
    return circ


def circ_qaoa(terms, depth, gammas, betas, **circuit_opts):
    """QAOA circuit for an Ising problem given as ``terms``
    {(i, j): weight} (reference ``circ_qaoa``)."""
    terms = dict(terms)
    n = max(itertools.chain(*terms)) + 1
    circ = Circuit(n, **circuit_opts)
    for q in range(n):
        circ.h(q)
    for d in range(depth):
        for (i, j), w in terms.items():
            circ.rzz(2 * gammas[d] * w, i, j, gate_round=d)
        for q in range(n):
            circ.rx(2 * betas[d], q, gate_round=d)
    return circ


def circ_rand_supremacy_like(n, depth, seed=None, **circuit_opts):
    """Random circuit in the style of the google supremacy circuits:
    layers of sqrt-gates + fsim entanglers on a chain pairing."""
    rng = np.random.default_rng(seed)
    circ = Circuit(n, **circuit_opts)
    sq_gates = ["X_1_2", "Y_1_2", "W_1_2"]
    last = [None] * n
    for q in range(n):
        circ.h(q)
    for d in range(depth):
        for q in range(n):
            choices = [g for g in sq_gates if g != last[q]]
            g = rng.choice(choices)
            last[q] = g
            circ.apply_gate(g, q, gate_round=d)
        start = d % 2
        for i in range(start, n - 1, 2):
            circ.fsim(np.pi / 2, np.pi / 6, i, i + 1, gate_round=d)
    return circ


__all__ = [
    "circ_ansatz_1D_zigzag", "circ_ansatz_1D_brickwork",
    "circ_ansatz_1D_rand", "circ_a2a_rand", "circ_qaoa",
    "circ_rand_supremacy_like",
]
