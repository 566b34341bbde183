"""Model Hamiltonians from edge lists, as ``SparseOperatorBuilder``s: a copy
of ``quimb_tpu/operator/models.py`` (reference ``quimb/operator/models.py``:
the Heisenberg and Fermi-Hubbard builders, ``rand_operator``)."""

import itertools

from .builder import SparseOperatorBuilder
from .hilbertspace import HilbertSpace


def heisenberg_from_edges(edges, j=1.0, b=0.0, hilbert_space=None):
    """Heisenberg model on arbitrary edges (reference
    ``quimb.operator.models.heisenberg_from_edges``)."""
    try:
        jx, jy, jz = j
    except TypeError:
        jx = jy = jz = j
    H = SparseOperatorBuilder(hilbert_space=hilbert_space)
    for (a, bnode) in edges:
        if jx == jy:
            if jx:
                H += jx / 2, ("+", a), ("-", bnode)
                H += jx / 2, ("-", a), ("+", bnode)
        else:
            if jx:
                H += jx, ("sx", a), ("sx", bnode)
            if jy:
                H += jy, ("sy", a), ("sy", bnode)
        if jz:
            H += jz, ("sz", a), ("sz", bnode)
    if b:
        sites = sorted(set(itertools.chain.from_iterable(edges)))
        for s in sites:
            H += -b, ("sz", s)
    return H


def fermi_hubbard_from_edges(edges, t=1.0, U=1.0, mu=0.0,
                             hilbert_space=None):
    """Spinful Fermi-Hubbard on arbitrary edges: site i splits into
    modes 2i (up) and 2i+1 (down) (reference
    ``fermi_hubbard_from_edges``)."""
    H = SparseOperatorBuilder(hilbert_space=hilbert_space)
    for (a, b) in edges:
        for spin in (0, 1):
            ma, mb = 2 * a + spin, 2 * b + spin
            if t:
                H += -t, ("cdag", ma), ("c", mb)
                H += -t, ("cdag", mb), ("c", ma)
    sites = sorted(set(itertools.chain.from_iterable(edges)))
    for s in sites:
        if U:
            H += U, ("n", 2 * s), ("n", 2 * s + 1)
        if mu:
            H += -mu, ("n", 2 * s)
            H += -mu, ("n", 2 * s + 1)
    return H


def fermi_hubbard_spinless_from_edges(edges, t=1.0, V=0.0, mu=0.0,
                                      hilbert_space=None):
    """Spinless fermions with hopping and nearest-neighbour
    interaction."""
    H = SparseOperatorBuilder(hilbert_space=hilbert_space)
    for (a, b) in edges:
        if t:
            H += -t, ("cdag", a), ("c", b)
            H += -t, ("cdag", b), ("c", a)
        if V:
            H += V, ("n", a), ("n", b)
    if mu:
        sites = sorted(set(itertools.chain.from_iterable(edges)))
        for s in sites:
            H += -mu, ("n", s)
    return H


def rand_operator(n, m, k, kmin=None, seed=None, ops="XYZ"):
    """Random ``n``-qubit operator with ``m`` terms of ``k`` (or
    ``kmin..k``) single-site factors and gaussian coefficients
    (reference ``rand_operator`` operator/models.py:424)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    allowed = list(ops)
    if kmin is None:
        kmin = k
    if not (0 <= kmin <= k <= n):
        raise ValueError("need 0 <= kmin <= k <= n")

    H = SparseOperatorBuilder(
        hilbert_space=HilbertSpace(tuple(range(n)))
    )
    for _ in range(m):
        coeff = float(rng.normal())
        ki = k if kmin == k else int(rng.integers(kmin, k + 1))
        regs = rng.choice(np.arange(n), size=ki, replace=False)
        term = tuple(
            (str(rng.choice(allowed)), int(r)) for r in regs
        )
        H += (coeff, *term)
    return H
