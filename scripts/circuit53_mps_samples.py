"""Record quimb_tpu's ``CircuitMPS`` values of the 53-qubit circuit.

Builds ``benchref/circuit53.py``'s circuit (n=53, depth 12, seed 7) as
quimb_tpu's ``CircuitMPS`` (complex128, ``max_bond=None``,
``cutoff=1e-10``), JAX on the CPU, and prints one JSON line with the
seconds the gates took, the bond sizes, ``fidelity_estimate()``, the five
amplitudes of REFBASE (``amp0`` and the four bitstrings of
``benchref/measure_tpu_circuit53.py``, drawn from
``np.random.default_rng(0)``), the strings of ``sample(C, seed=42)`` (C=20
unless given) and the seconds the sampling took. ``chip_smoke.py`` holds
the port's ``CircuitMPS`` to these values. Run from the root of the
repository::

    JAX_PLATFORMS=cpu python scripts/circuit53_mps_samples.py [C]
"""

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "benchref"))

from circuit53 import qasm_circuit  # noqa: E402


def main():
    C = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    import quimb_tpu.tensor as qtn

    t0 = time.perf_counter()
    circ = qtn.CircuitMPS.from_openqasm2_str(qasm_circuit(53, 12),
                                             dtype="complex128")
    gate_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    bits = ["0" * 53] + ["".join(rng.choice(["0", "1"], size=53))
                         for _ in range(4)]
    amps = {b: complex(circ.amplitude(b)) for b in bits}
    t0 = time.perf_counter()
    samples = list(circ.sample(C, seed=42))
    print(json.dumps({
        "gate_seconds": gate_s,
        "bond_sizes": circ._psi.bond_sizes(),
        "fidelity_estimate": circ.fidelity_estimate(),
        "amplitudes": {b: [a.real, a.imag] for b, a in amps.items()},
        "samples": samples,
        "sample_seconds": time.perf_counter() - t0,
    }))


if __name__ == "__main__":
    main()
