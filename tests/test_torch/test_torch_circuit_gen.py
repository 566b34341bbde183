"""quimb_torch's circuit ansatz generators (``tensor/circuit_gen.py``)
against quimb_tpu's, on the CPU.

Both packages draw the gate parameters from ``np.random.default_rng``, so
the circuits hold the same gates; their amplitudes (complex128, a few
dozen gates on six qubits) agree to 1e-12.
"""

import numpy as np
import pytest

import quimb_tpu.tensor as jtn
import quimb_torch.tensor as ttn
from quimb_tpu.ops.contraction import contract_backend as jbackend

CPU = "cpu"
N = 6

BUILDERS = {
    "zigzag": lambda pkg, **kw: pkg.circ_ansatz_1D_zigzag(
        N, 3, seed=1, circuit_opts=kw),
    "brickwork": lambda pkg, **kw: pkg.circ_ansatz_1D_brickwork(
        N, 4, seed=2, **kw),
    "brickwork cyclic": lambda pkg, **kw: pkg.circ_ansatz_1D_brickwork(
        N, 4, cyclic=True, seed=3, **kw),
    "rand": lambda pkg, **kw: pkg.circ_ansatz_1D_rand(N, 5, seed=4, **kw),
    "a2a": lambda pkg, **kw: pkg.circ_a2a_rand(N, 5, seed=5, **kw),
    "qaoa": lambda pkg, **kw: pkg.circ_qaoa(
        {(0, 1): 1.0, (1, 2): -0.5, (2, 5): 0.7, (3, 4): 0.2}, 2,
        gammas=[0.1, 0.4], betas=[0.3, 0.2], **kw),
    "supremacy-like": lambda pkg, **kw: pkg.circ_rand_supremacy_like(
        N, 4, seed=6, **kw),
}


def _gates(circ):
    return [(g.label, tuple(np.round(np.asarray(g.params, dtype=float), 14)),
             g.qubits, g.round) for g in circ.gates]


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_circuit_gen_matches(name):
    t = BUILDERS[name](ttn, device=CPU)
    j = BUILDERS[name](jtn)
    assert _gates(t) == _gates(j)
    for b in ("000000", "101100", "011011"):
        with jbackend("numpy"):
            want = complex(j.amplitude(b))
        assert complex(t.amplitude(b)) == pytest.approx(want, abs=1e-12)
