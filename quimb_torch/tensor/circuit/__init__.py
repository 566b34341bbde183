"""Quantum circuit simulators (reference ``quimb/tensor/circuit/``): the
exact lazy tensor-network ``Circuit``, its gates and its QASM parsers."""

from .core import Circuit, CircuitBase, CircuitDense
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
    "Gate",
    "ALL_GATES",
    "CONSTANT_GATES",
    "GATE_SIZE",
    "PARAM_GATES",
    "register_constant_gate",
    "register_param_gate",
    "register_special_gate",
]
