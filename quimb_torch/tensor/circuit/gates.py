"""Quantum gate definitions and registry.

Copy of quimb_tpu's ``tensor/circuit/gates.py`` (reference
``quimb/tensor/circuit/gates.py``: constant gate table :107-142,
``register_constant_gate`` :62, ``register_param_gate`` :75,
``register_special_gate`` :91, ~40 constant + ~25 parametric gates). It
is numpy only; the port keeps its own copy so that it imports nothing of
quimb_tpu.

Gates are built as small host numpy constants; the circuit casts them to
its dtype when it applies them, and the lazy circuit keeps them on the
host until the final contraction moves its operands to the device.
"""

import math

import numpy as np

# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

CONSTANT_GATES = {}
PARAM_GATES = {}
SPECIAL_GATES = {}
GATE_SIZE = {}


def register_constant_gate(name, G, num_qubits, tag=None):
    CONSTANT_GATES[name.upper()] = np.asarray(G)
    GATE_SIZE[name.upper()] = num_qubits


def register_param_gate(name, param_fn, num_qubits, num_params=None):
    PARAM_GATES[name.upper()] = param_fn
    GATE_SIZE[name.upper()] = num_qubits


def register_special_gate(name, fn, num_qubits):
    SPECIAL_GATES[name.upper()] = fn
    GATE_SIZE[name.upper()] = num_qubits


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------

_SQ2 = 1 / math.sqrt(2)

_I = np.eye(2)
_X = np.array([[0, 1], [1, 0]], dtype=complex)
_Y = np.array([[0, -1j], [1j, 0]])
_Z = np.diag([1.0, -1.0]).astype(complex)
_H = _SQ2 * np.array([[1, 1], [1, -1]], dtype=complex)
_S = np.diag([1, 1j])
_SDG = np.diag([1, -1j])
_T = np.diag([1, np.exp(1j * math.pi / 4)])
_TDG = np.diag([1, np.exp(-1j * math.pi / 4)])

register_constant_gate("I", _I, 1)
register_constant_gate("X", _X, 1)
register_constant_gate("Y", _Y, 1)
register_constant_gate("Z", _Z, 1)
register_constant_gate("H", _H, 1)
register_constant_gate("S", _S, 1)
register_constant_gate("SDG", _SDG, 1)
register_constant_gate("T", _T, 1)
register_constant_gate("TDG", _TDG, 1)

# sqrt gates (Google supremacy set)
_X_1_2 = 0.5 * np.array([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]])
_Y_1_2 = 0.5 * np.array([[1 + 1j, -1 - 1j], [1 + 1j, 1 + 1j]])
_W = _SQ2 * (_X + _Y)
_wl, _wv = np.linalg.eigh(_W)
_W_1_2 = (_wv * np.sqrt(_wl.astype(complex))) @ _wv.conj().T
_HZ = _SQ2 * (_X + _Z)
_hl, _hv = np.linalg.eigh(_HZ)
_HZ_1_2 = (_hv * np.sqrt(_hl.astype(complex))) @ _hv.conj().T

register_constant_gate("X_1_2", _X_1_2, 1)
register_constant_gate("Y_1_2", _Y_1_2, 1)
register_constant_gate("W_1_2", _W_1_2, 1)
register_constant_gate("HZ_1_2", _HZ_1_2, 1)
register_constant_gate("Z_1_2", _S, 1)
register_constant_gate("SX", _X_1_2, 1)
register_constant_gate("SXDG", _X_1_2.conj().T, 1)
register_constant_gate("V", _X_1_2, 1)
register_constant_gate("VDG", _X_1_2.conj().T, 1)

# two-qubit constants
_CNOT = np.array([
    [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0],
], dtype=complex)
_CY = np.eye(4, dtype=complex)
_CY[2:, 2:] = _Y
_CZ = np.diag([1.0, 1, 1, -1]).astype(complex)
_SWAP = np.array([
    [1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1],
], dtype=complex)
_ISWAP = np.array([
    [1, 0, 0, 0], [0, 0, 1j, 0], [0, 1j, 0, 0], [0, 0, 0, 1],
])

register_constant_gate("CNOT", _CNOT, 2)
register_constant_gate("CX", _CNOT, 2)
register_constant_gate("CY", _CY, 2)
register_constant_gate("CZ", _CZ, 2)
register_constant_gate("SWAP", _SWAP, 2)
register_constant_gate("ISWAP", _ISWAP, 2)
register_constant_gate("IS", _ISWAP, 2)

# three-qubit constants
_CCX = np.eye(8, dtype=complex)
_CCX[6:, 6:] = _X
_CCY = np.eye(8, dtype=complex)
_CCY[6:, 6:] = _Y
_CCZ = np.diag([1.0] * 7 + [-1.0]).astype(complex)
_CSWAP = np.eye(8, dtype=complex)
_CSWAP[4:, 4:] = _SWAP

register_constant_gate("CCX", _CCX, 3)
register_constant_gate("TOFFOLI", _CCX, 3)
register_constant_gate("CCNOT", _CCX, 3)
register_constant_gate("IDEN", np.eye(2, dtype=complex), 1)
register_constant_gate("CCY", _CCY, 3)
register_constant_gate("CCZ", _CCZ, 3)
register_constant_gate("CSWAP", _CSWAP, 3)
register_constant_gate("FREDKIN", _CSWAP, 3)


# ---------------------------------------------------------------------------
# parametric gates — plain functions of float params, numpy-built
# ---------------------------------------------------------------------------


def rx_gate(theta):
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return np.array([[c, -1j * s], [-1j * s, c]])


def ry_gate(theta):
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return np.array([[c, -s], [s, c]], dtype=complex)


def rz_gate(theta):
    return np.diag([np.exp(-1j * theta / 2), np.exp(1j * theta / 2)])


def u3_gate(theta, phi, lamda):
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return np.array([
        [c, -np.exp(1j * lamda) * s],
        [np.exp(1j * phi) * s, np.exp(1j * (phi + lamda)) * c],
    ])


def u2_gate(phi, lamda):
    return u3_gate(math.pi / 2, phi, lamda)


def u1_gate(lamda):
    return np.diag([1.0, np.exp(1j * lamda)])


def phase_gate(lamda):
    return u1_gate(lamda)


def _controlled(U):
    n = U.shape[0]
    out = np.eye(2 * n, dtype=complex)
    out[n:, n:] = U
    return out


def cu3_gate(theta, phi, lamda):
    return _controlled(u3_gate(theta, phi, lamda))


def cu2_gate(phi, lamda):
    return _controlled(u2_gate(phi, lamda))


def cu1_gate(lamda):
    return _controlled(u1_gate(lamda))


def crx_gate(theta):
    return _controlled(rx_gate(theta))


def cry_gate(theta):
    return _controlled(ry_gate(theta))


def crz_gate(theta):
    return _controlled(rz_gate(theta))


def rxx_gate(theta):
    c, s = math.cos(theta / 2), -1j * math.sin(theta / 2)
    out = np.diag([c, c, c, c]).astype(complex)
    out[0, 3] = out[1, 2] = out[2, 1] = out[3, 0] = s
    return out


def ryy_gate(theta):
    c, s = math.cos(theta / 2), 1j * math.sin(theta / 2)
    out = np.diag([c, c, c, c]).astype(complex)
    out[0, 3] = out[3, 0] = s
    out[1, 2] = out[2, 1] = -s
    return out


def rzz_gate(theta):
    p = np.exp(-1j * theta / 2)
    return np.diag([p, p.conjugate(), p.conjugate(), p])


def xx_minus_yy_gate(theta, beta=0.0):
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    eb = np.exp(1j * beta)
    return np.array([
        [c, 0, 0, -1j * s * eb.conjugate()],
        [0, 1, 0, 0],
        [0, 0, 1, 0],
        [-1j * s * eb, 0, 0, c],
    ])


def xx_plus_yy_gate(theta, beta=0.0):
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    eb = np.exp(1j * beta)
    return np.array([
        [1, 0, 0, 0],
        [0, c, -1j * s * eb.conjugate(), 0],
        [0, -1j * s * eb, c, 0],
        [0, 0, 0, 1],
    ])


def givens_gate(theta):
    c, s = math.cos(theta), math.sin(theta)
    return np.array([
        [1, 0, 0, 0],
        [0, c, -s, 0],
        [0, s, c, 0],
        [0, 0, 0, 1],
    ], dtype=complex)


def givens2_gate(theta, phi):
    c, s = math.cos(theta), math.sin(theta)
    ep = np.exp(1j * phi)
    return np.array([
        [1, 0, 0, 0],
        [0, c, -s * ep.conjugate(), 0],
        [0, s * ep, c, 0],
        [0, 0, 0, 1],
    ])


def fsim_gate(theta, phi):
    c, s = math.cos(theta), math.sin(theta)
    return np.array([
        [1, 0, 0, 0],
        [0, c, -1j * s, 0],
        [0, -1j * s, c, 0],
        [0, 0, 0, np.exp(-1j * phi)],
    ])


def fsimg_gate(theta, zeta, chi, gamma, phi):
    c, s = math.cos(theta), math.sin(theta)
    return np.array([
        [1, 0, 0, 0],
        [0, np.exp(-1j * (gamma + zeta)) * c,
         -1j * np.exp(-1j * (gamma - chi)) * s, 0],
        [0, -1j * np.exp(-1j * (gamma + chi)) * s,
         np.exp(-1j * (gamma - zeta)) * c, 0],
        [0, 0, 0, np.exp(-1j * (2 * gamma + phi))],
    ])


def cphase_gate(theta):
    return np.diag([1.0, 1, 1, np.exp(1j * theta)])


def su4_gate(*params):
    """General SU(4) gate from 15 parameters (reference ``su4``):
    two single-qubit U3s on each side of three two-qubit rotations."""
    (t1, p1, l1, t2, p2, l2, t3, p3, l3, t4, p4, l4,
     txx, tyy, tzz) = params
    A = np.kron(u3_gate(t1, p1, l1), u3_gate(t2, p2, l2))
    core = rxx_gate(txx) @ ryy_gate(tyy) @ rzz_gate(tzz)
    B = np.kron(u3_gate(t3, p3, l3), u3_gate(t4, p4, l4))
    return B @ core @ A


register_param_gate("RX", rx_gate, 1)
register_param_gate("RY", ry_gate, 1)
register_param_gate("RZ", rz_gate, 1)
register_param_gate("U3", u3_gate, 1)
register_param_gate("U2", u2_gate, 1)
register_param_gate("U1", u1_gate, 1)
register_param_gate("P", phase_gate, 1)
register_param_gate("PHASE", phase_gate, 1)
register_param_gate("CU3", cu3_gate, 2)
register_param_gate("CU2", cu2_gate, 2)
register_param_gate("CU1", cu1_gate, 2)
register_param_gate("CP", cphase_gate, 2)
register_param_gate("CPHASE", cphase_gate, 2)
register_param_gate("CRX", crx_gate, 2)
register_param_gate("CRY", cry_gate, 2)
register_param_gate("CRZ", crz_gate, 2)
register_param_gate("RXX", rxx_gate, 2)
register_param_gate("RYY", ryy_gate, 2)
register_param_gate("RZZ", rzz_gate, 2)
register_param_gate("XX_PLUS_YY", xx_plus_yy_gate, 2)
register_param_gate("XX_MINUS_YY", xx_minus_yy_gate, 2)
# reference registry spelling (gates.py:570,601)
register_param_gate("XXPLUSYY", xx_plus_yy_gate, 2)
register_param_gate("XXMINUSYY", xx_minus_yy_gate, 2)
register_param_gate("GIVENS", givens_gate, 2)
register_param_gate("GIVENS2", givens2_gate, 2)
register_param_gate("FSIM", fsim_gate, 2)
register_param_gate("FS", fsim_gate, 2)
register_param_gate("FSIMG", fsimg_gate, 2)
register_param_gate("SU4", su4_gate, 2)


ALL_GATES = set(CONSTANT_GATES) | set(PARAM_GATES) | set(SPECIAL_GATES)
ONE_QUBIT_GATES = {g for g, n in GATE_SIZE.items() if n == 1}
TWO_QUBIT_GATES = {g for g, n in GATE_SIZE.items() if n == 2}


class Gate:
    """A gate instance: label + params + qubits (+ optional controls)
    (reference ``Gate`` dataclass circuit/core.py)."""

    __slots__ = ("_label", "_params", "_qubits", "_controls", "_round",
                 "_parametrize", "_tags", "_array")

    def __init__(self, label, params=(), qubits=(), controls=None,
                 round=None, parametrize=False, tags=None, array=None):
        self._label = label.upper() if isinstance(label, str) else label
        self._params = tuple(params)
        self._qubits = tuple(qubits)
        self._controls = tuple(controls) if controls else ()
        self._round = round
        self._parametrize = parametrize
        self._tags = tags
        self._array = array

    @classmethod
    def from_raw(cls, U, qubits, tags=None):
        g = cls("RAW", (), qubits, tags=tags, array=np.asarray(U))
        return g

    @property
    def label(self):
        return self._label

    @property
    def params(self):
        return self._params

    @property
    def qubits(self):
        return self._qubits

    @property
    def controls(self):
        return self._controls

    @property
    def round(self):
        return self._round

    @property
    def parametrize(self):
        return self._parametrize

    @property
    def tags(self):
        return self._tags

    @property
    def total_qubit_count(self):
        return len(self._qubits) + len(self._controls)

    def build_array(self):
        """The raw (2^n, 2^n) unitary."""
        if self._array is not None:
            U = self._array
        elif self._label in CONSTANT_GATES:
            U = CONSTANT_GATES[self._label]
        elif self._label in PARAM_GATES:
            U = PARAM_GATES[self._label](*self._params)
        else:
            raise KeyError(f"unknown gate {self._label}")
        for _ in self._controls:
            U = _controlled(U)
        return U

    @property
    def array(self):
        return self.build_array()

    def copy(self):
        return Gate(
            self._label, self._params, self._qubits, self._controls,
            self._round, self._parametrize, self._tags, self._array,
        )

    @property
    def special(self):
        """Whether this gate requires special (non-unitary-array)
        application (reference ``Gate.special``)."""
        return self._label in ("SWAP",) and False

    @property
    def tag(self):
        """A tag identifying this gate: its label plus round if any
        (reference ``Gate.tag``)."""
        if self._round is not None:
            return f"ROUND_{self._round}"
        return None

    def copy_with(self, **kwargs):
        """Copy of this gate with some attributes changed (reference
        ``Gate.copy_with``)."""
        return Gate(
            kwargs.get("label", self._label),
            kwargs.get("params", self._params),
            kwargs.get("qubits", self._qubits),
            kwargs.get("controls", self._controls),
            kwargs.get("round", self._round),
            kwargs.get("parametrize", self._parametrize),
            kwargs.get("tags", self._tags),
            kwargs.get("array", self._array),
        )

    def build_mpo(self, L=None, **kwargs):
        """An MPO representation of this (possibly controlled) gate
        (reference ``Gate.build_mpo`` gates.py:1123). The port has no MPO
        class yet."""
        raise NotImplementedError(
            "Gate.build_mpo is not ported to quimb_torch yet: ROADMAP item "
            "14(b) (tn1d/core.py's MatrixProductOperator)"
        )

    def __repr__(self):
        return (
            f"<Gate(label={self._label}, params={self._params}, "
            f"qubits={self._qubits})>"
        )
