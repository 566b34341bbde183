"""Record quimb_tpu's samples of the 53-qubit depth-12 circuit.

Builds ``benchref/circuit53.py``'s circuit (n=53, depth 12, seed 7) in
quimb_tpu, JAX on the CPU, and prints one JSON line with ``amp0``, the
strings of ``sample(C, seed=42)`` (C=20 unless given) and the seconds the
sampling took. ``chip_smoke.py`` holds the port's samples of the same call
to these strings. Run from the root of the repository::

    JAX_PLATFORMS=cpu python scripts/circuit53_samples.py [C]
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "benchref"))

from circuit53 import qasm_circuit  # noqa: E402


def main():
    C = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    import quimb_tpu.tensor as qtn

    circ = qtn.Circuit.from_openqasm2_str(qasm_circuit(53, 12))
    a0 = complex(circ.amplitude("0" * 53))
    t0 = time.perf_counter()
    samples = list(circ.sample(C, seed=42))
    print(json.dumps({"amp0": [a0.real, a0.imag], "samples": samples,
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
