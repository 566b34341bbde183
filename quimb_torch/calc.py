"""Closed-form reference values of quimb_tpu's ``calc.py``.

For now this holds :func:`heisenberg_energy`, the finite-size scaling
formula the ring DMRG is held to; the rest of quimb_tpu's ``calc.py``
(entropies, fidelities, decompositions) is not ported yet.
"""

import math


def heisenberg_energy(L):
    """Asymptotic ground energy of the length-``L`` spin-1/2 isotropic
    antiferromagnetic Heisenberg chain (spin-operator convention), from
    the scaling formula of Nickel, J. Phys. Commun. 1, 055021 (2017)."""
    Einf = (0.5 - 2 * math.log(2)) * L
    Efinite = math.pi**2 / (6 * L)
    correction = 1 + 0.375 / math.log(L) ** 3
    return (Einf - Efinite * correction) / 2
