"""Quantum circuit simulators (reference ``quimb/tensor/circuit/``): the
exact lazy tensor-network ``Circuit``, the MPS simulators ``CircuitMPS``,
``CircuitPermMPS`` and ``CircuitMPSLazy``, the gates and the QASM
parsers."""

from .core import Circuit, CircuitBase, CircuitDense
from .mps import CircuitMPS, CircuitMPSLazy, CircuitPermMPS
from .gates import (
    ALL_GATES,
    CONSTANT_GATES,
    GATE_SIZE,
    PARAM_GATES,
    Gate,
    register_constant_gate,
    register_param_gate,
    register_special_gate,
)

__all__ = [
    "Circuit",
    "CircuitBase",
    "CircuitDense",
    "CircuitMPS",
    "CircuitMPSLazy",
    "CircuitPermMPS",
    "Gate",
    "ALL_GATES",
    "CONSTANT_GATES",
    "GATE_SIZE",
    "PARAM_GATES",
    "register_constant_gate",
    "register_param_gate",
    "register_special_gate",
]
