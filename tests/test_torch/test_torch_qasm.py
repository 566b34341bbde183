"""quimb_torch's copies of ``tensor/circuit/qasm.py`` and
``tensor/circuit/gates.py`` against quimb_tpu's, on the CPU.

The parsers are pure Python: on the forms of quimb_tpu's own QASM tests
(OpenQASM 2 and 3, qsim) both give the same gate lists (label,
parameters, qubits, controls, round), the same register maps, symbols and
warnings, and raise the same errors. The gate registries hold the same
arrays (exactly: both are the same numpy arithmetic). A few circuits built
from these strings in both packages agree in their dense states at 1e-12.
"""

import math
import warnings

import numpy as np
import pytest
import torch

import quimb_tpu.tensor as jtn
import quimb_torch.tensor as ttn
from quimb_tpu.tensor.circuit import gates as jgates
from quimb_tpu.tensor.circuit import qasm as jqasm
from quimb_torch.tensor.circuit import gates as tgates
from quimb_torch.tensor.circuit import qasm as tqasm

Q2 = {
    "basic": """
        OPENQASM 2.0;
        include "qelib1.inc";
        qreg q[2];
        h q[0];
        cx q[0], q[1];
        """,
    "custom_gates": """
        OPENQASM 2.0;
        include "qelib1.inc";
        qreg q[3];
        gate bell a, b { h a; cx a, b; }
        gate wiggle(t) a { rx(t) a; rz(2*t) a; }
        bell q[0], q[1];
        wiggle(0.3) q[2];
        ccx q[0], q[1], q[2];
        """,
    "nested_custom_gates": """
        OPENQASM 2.0;
        include "qelib1.inc";
        qreg q[2];
        gate inner(t) a { ry(t) a; }
        gate outer(t) a, b { inner(t/2) a; cx a, b; inner(-t) b; }
        outer(0.8) q[0], q[1];
        """,
    "gate_prefix": """
        OPENQASM 2.0;
        include "qelib1.inc";
        gate gate_Evo(p) a, b { rz(p) a; rz(-p) b; }
        qreg q[2];
        gate_Evo(0.1) q[0], q[1];
        """,
    "identity": """
        OPENQASM 2.0;
        include "qelib1.inc";
        qreg q[2];
        x q[0];
        id q[0];
        i q[1];
        """,
    "aliases": """
        OPENQASM 2.0;
        qreg q[3];
        cnot q[0], q[1];
        toffoli q[0], q[1], q[2];
        fredkin q[0], q[1], q[2];
        p(0.1) q[0];
        u(0.1, 0.2, 0.3) q[1];
        """,
    "broadcast": """
        OPENQASM 2.0;
        qreg a[2];
        qreg b[2];
        h a;
        cx a, b;
        cx a[0], b;
        """,
    "math": """
        OPENQASM 2.0;
        qreg q[1];
        rx(sin(0.5) + cos(pi/3)) q[0];
        rz(sqrt(2) * ln(2)) q[0];
        """,
    "measure_warns": """
        OPENQASM 2.0;
        qreg q[2];
        creg c[2];
        h q[0];
        measure q -> c;
        """,
    "comments": """
        OPENQASM 2.0; // trailing comment
        qreg q[2]; h q[0]; /* inline
        block */ cx q[0], q[1]; // done
        """,
    "broadcast_mismatch": """
        OPENQASM 2.0;
        qreg a[2];
        qreg b[3];
        cx a, b;
        """,
    "reset": "OPENQASM 2.0;\nqreg q[1];\nreset q[0];\n",
    "conditional": "OPENQASM 2.0;\nqreg q[1];\ncreg c[1];\n"
                   "if (c==1) x q[0];\n",
    "unknown_gate": "OPENQASM 2.0;\nqreg q[1];\nfrobnicate q[0];\n",
}

Q3 = {
    "basic": "OPENQASM 3.0;\nqubit[2] q;\nh q[0];\ncx q[0], q[1];\n"
             "rz(pi/4) q[1];\n",
    "single_qubit_decl": "OPENQASM 3.0;\nqubit a;\nqubit b;\nh a;\n"
                         "cx a, b;\n",
    "broadcast": "OPENQASM 3.0;\nqubit[3] q;\nqubit[3] r;\nh q;\ncx q, r;\n",
    "const_and_classical": """
        OPENQASM 3.0;
        qubit[1] q;
        const float w = pi / 2;
        float t = w * 2;
        int k = 3;
        rx(t / k) q[0];
        """,
    "assignment": """
        OPENQASM 3.0;
        qubit[1] q;
        float t = 1.0;
        t = t + 0.5;
        rx(t) q[0];
        """,
    "symbolic_inputs": """
        OPENQASM 3.0;
        input float theta;
        qubit[2] q;
        ry(theta) q[0];
        cx q[0], q[1];
        rz(theta * 2) q[1];
        """,
    "custom_symbolic": """
        OPENQASM 3.0;
        input float a;
        qubit[2] q;
        gate foo(x) s, t { rx(x) s; cz s, t; ry(x / 2) t; }
        foo(a) q[0], q[1];
        foo(0.5) q[1], q[0];
        """,
    "shadowing": """
        OPENQASM 3.0;
        input float a;
        qubit[1] q;
        gate foo(a, aa) s { u3(aa, a, aa) s; }
        foo(0.1, a) q[0];
        """,
    "array_index": """
        OPENQASM 3.0;
        input float theta;
        array[float, 2] angles = {theta, theta / 2};
        qubit[2] q;
        rx(angles[0]) q[0];
        ry(angles[1]) q[1];
        """,
    "output_decl": "OPENQASM 3.0;\noutput bit r;\nqubit[1] q;\n",
    "for_loop": "OPENQASM 3.0;\nqubit[1] q;\nfor int i in [0:4] { x q[0]; }\n",
    "modifier": "OPENQASM 3.0;\nqubit[2] q;\nctrl @ x q[0], q[1];\n",
    "measure": """
        OPENQASM 3.0;
        bit[2] c;
        qubit[2] q;
        h q[0];
        cx q[0], q[1];
        c[0] = measure q[0];
        c[1] = measure q[1];
        """,
    "gphase": "OPENQASM 3.0;\nqubit[1] q;\ngphase(pi/2);\nx q[0];\n",
    "one_line": "OPENQASM 3.0; qubit[2] q; h q[0]; cx q[0], q[1];",
}

QSIM = {
    "basic": "2\n0 h 0\n0 h 1\n1 cz 0 1\n2 rz 0 0.5\n",
    "supremacy": "3\n0 x_1_2 0\n0 y_1_2 1\n0 hz_1_2 2\n1 fs 0 1 0.3 0.2\n"
                 "2 cz 1 2\n3 t 0\n",
}

PARSERS = {
    "qasm2": (Q2, tqasm.parse_openqasm2_str, jqasm.parse_openqasm2_str),
    "qasm3": (Q3, tqasm.parse_openqasm3_str, jqasm.parse_openqasm3_str),
    "qsim": (QSIM, tqasm.parse_qsim_str, jqasm.parse_qsim_str),
}
CASES = [(kind, name) for kind, (strs, _, _) in PARSERS.items()
         for name in strs]


def _param(p):
    """A parameter, comparable by ``==``: an unbound symbol is nan, and a
    deferred expression is compared by its source."""
    if isinstance(p, float) and math.isnan(p):
        return "nan"
    return p if isinstance(p, (int, float, complex)) else repr(p)


def _gate_key(g):
    return (g.label, tuple(map(_param, g.params)), g.qubits, g.controls,
            g.round, g.parametrize)


def _parse(fn, src):
    """(result or the raised error's type, the warnings' messages)."""
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        try:
            out = fn(src)
        except Exception as e:  # compared by type between the packages
            out = type(e).__name__
    return out, [(w.category.__name__, str(w.message)) for w in record]


@pytest.mark.parametrize("kind,name", CASES,
                         ids=[f"{k}-{n}" for k, n in CASES])
def test_parsers_match(kind, name):
    strs, tfn, jfn = PARSERS[kind]
    (t, tw), (j, jw) = _parse(tfn, strs[name]), _parse(jfn, strs[name])
    assert tw == jw
    if isinstance(j, str):
        assert t == j
        return
    assert t.keys() == j.keys()
    assert [_gate_key(g) for g in t["gates"]] == \
        [_gate_key(g) for g in j["gates"]]
    for key in t:
        if key != "gates":
            assert repr(t[key]) == repr(j[key])


def test_gate_registries_match():
    assert tgates.GATE_SIZE == jgates.GATE_SIZE
    assert tgates.ALL_GATES == jgates.ALL_GATES
    for name, G in jgates.CONSTANT_GATES.items():
        np.testing.assert_array_equal(tgates.CONSTANT_GATES[name], G)
    rng = np.random.default_rng(0)
    for name, fn in jgates.PARAM_GATES.items():
        n = 15 if fn.__name__ == "su4_gate" else \
            fn.__code__.co_argcount
        params = rng.uniform(0, 2 * math.pi, n)
        np.testing.assert_array_equal(tgates.PARAM_GATES[name](*params),
                                      fn(*params))


def test_gate_build_array_with_controls_matches():
    for label, params in (("RX", (0.3,)), ("U3", (0.1, 0.2, 0.3)),
                          ("FSIM", (0.4, 0.5))):
        t = tgates.Gate(label, params, (1,), controls=(0, 2))
        j = jgates.Gate(label, params, (1,), controls=(0, 2))
        np.testing.assert_array_equal(t.build_array(), j.build_array())
    with pytest.raises(NotImplementedError, match="item 14"):
        tgates.Gate("CZ", (), (0, 1)).build_mpo()


@pytest.mark.parametrize("kind,name", [
    ("qasm2", "custom_gates"), ("qasm2", "nested_custom_gates"),
    ("qasm2", "aliases"), ("qasm3", "broadcast"), ("qsim", "supremacy"),
])
def test_circuits_from_strings_match(kind, name):
    src = PARSERS[kind][0][name]
    ctor = {"qasm2": "from_openqasm2_str", "qasm3": "from_openqasm3_str",
            "qsim": "from_qsim_str"}[kind]
    t = getattr(ttn.Circuit, ctor)(src, device="cpu")
    j = getattr(jtn.Circuit, ctor)(src)
    got = t.to_dense().numpy().ravel()
    want = np.asarray(j.to_dense()).ravel()
    assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want)


def test_symbolic_parameters_bind_alike():
    src = Q3["custom_symbolic"]
    t = ttn.Circuit.from_openqasm3_str(src, device="cpu")
    j = jtn.Circuit.from_openqasm3_str(src)
    assert t.named_param_names == j.named_param_names == ("a",)
    t.set_params({"a": 0.4})
    j.set_params({"a": 0.4})
    assert [_gate_key(g) for g in t.gates] == [_gate_key(g) for g in j.gates]
    assert t.get_params() == j.get_params()
    got = t.to_dense()
    assert got.device == torch.device("cpu")
    want = np.asarray(j.to_dense()).ravel()
    assert np.linalg.norm(got.numpy().ravel() - want) <= \
        1e-12 * np.linalg.norm(want)
