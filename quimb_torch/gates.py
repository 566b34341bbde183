"""A namespace of constant gates (port of ``quimb_tpu/gates.py``, reference
``quimb/gates.py``).

quimb_tpu makes its constants device arrays when the module is imported.
Here each is made on first access, on the package's default device (the
GPU), and kept: importing the module touches no device, so it imports on a
machine without CUDA, where reading a constant raises as every entry point
does. The gate builders are re-exported as they are and take ``device``.
"""

from .gen.operators import (
    CNOT,
    S_gate,
    T_gate,
    Wsqrt,
    Xsqrt,
    Ysqrt,
    Zsqrt,
    cX,
    cY,
    cZ,
    ccX,
    fredkin,
    hadamard,
    iswap,
    pauli,
    swap,
    toffoli,
)

_BUILDERS = {
    "I": lambda: pauli("I"),
    "X": lambda: pauli("X"),
    "Y": lambda: pauli("Y"),
    "Z": lambda: pauli("Z"),
    "H": hadamard,
    "S": S_gate,
    "T": T_gate,
    "W": lambda: (pauli("X") + pauli("Y")) / 2**0.5,
    "SWAP": swap,
    "ISWAP": iswap,
    "CX": cX,
    "CY": cY,
    "CZ": cZ,
    "CCX": ccX,
    "CCNOT": ccX,
    "CSWAP": fredkin,
}
_MADE = {}


def __getattr__(name):
    if name in _BUILDERS:
        if name not in _MADE:
            _MADE[name] = _BUILDERS[name]()
        return _MADE[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "I", "X", "Y", "Z", "H", "S", "T", "W", "SWAP", "ISWAP", "CX", "CY",
    "CZ", "CCX", "CCNOT", "CSWAP", "CNOT", "hadamard", "pauli", "swap",
    "iswap", "toffoli", "fredkin", "Xsqrt", "Ysqrt", "Zsqrt", "Wsqrt",
]
