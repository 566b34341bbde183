"""quimb_torch's MPS circuit simulators (``CircuitMPS``, ``CircuitPermMPS``,
``CircuitMPSLazy``) and ``Gate.build_mpo`` against quimb_tpu's, in
complex128 on the CPU.

Both packages build each circuit from one OpenQASM string
(``benchref/circuit53.py``'s ``qasm_circuit(10, 6)``, loaded by path;
numpy only). The truncation cutoff (1e-10) keeps the states exact to
1e-9 here, so amplitudes, reduced density matrices and expectations
agree to 1e-10 relative, and samples drawn with one seed are the same
strings.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import quimb_tpu.tensor as qtn
import quimb_torch
from quimb_torch.tensor.circuit.gates import Gate
from quimb_torch.tensor.tn1d import core as tc

CPU = "cpu"
N, DEPTH = 10, 6
BITS = ("0" * N, "0110100101", "1111100000")
CLASSES = ("CircuitMPS", "CircuitPermMPS", "CircuitMPSLazy")


def _n(x):
    x = getattr(x, "data", x)
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().numpy()
    return np.asarray(x)


@functools.lru_cache(maxsize=None)
def _qasm():
    path = Path(__file__).resolve().parents[2] / "benchref" / "circuit53.py"
    spec = importlib.util.spec_from_file_location("circuit53", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.qasm_circuit(N, DEPTH)


@functools.lru_cache(maxsize=None)
def _pair(name):
    """quimb_tpu's and the port's circuit of one class, from one string."""
    j = getattr(qtn, name).from_openqasm2_str(_qasm(), dtype="complex128")
    t = getattr(quimb_torch, name).from_openqasm2_str(
        _qasm(), dtype="complex128", device=CPU)
    return j, t


@functools.lru_cache(maxsize=None)
def _tpu_values(name):
    """quimb_tpu's amplitudes, <Z_3>, rho of (2, 7) and sample(5, seed=11)
    of the circuit."""
    j, _ = _pair(name)
    Z = np.diag([1.0, -1.0]).astype(complex)
    return ({b: complex(j.amplitude(b)) for b in BITS},
            complex(np.asarray(j.local_expectation(Z, 3))),
            _n(j.partial_trace((2, 7))),
            tuple(j.sample(5, seed=11)))


@pytest.mark.parametrize("name", CLASSES)
def test_amplitudes(name):
    want = _tpu_values(name)[0]
    _, t = _pair(name)
    for b in BITS:
        got = t.amplitude(b)
        assert isinstance(got, complex)
        assert abs(got - want[b]) <= 1e-10 * abs(want[b])


@pytest.mark.parametrize("name", CLASSES)
def test_local_expectation_and_partial_trace(name):
    _, zwant, rho_want, _ = _tpu_values(name)
    _, t = _pair(name)
    Z = torch.tensor(np.diag([1.0, -1.0]), dtype=torch.complex128)
    assert abs(complex(t.local_expectation(Z, 3)) - zwant) <= 1e-10
    rho = _n(t.partial_trace((2, 7)))
    assert rho.shape == (4, 4)
    np.testing.assert_allclose(rho, rho_want, rtol=0, atol=1e-12)
    assert abs(np.trace(rho) - 1) < 1e-9


@pytest.mark.parametrize("name", CLASSES)
def test_samples(name):
    """The exact sequential sampler, one seed: quimb_tpu's strings."""
    _, t = _pair(name)
    assert tuple(t.sample(5, seed=11)) == _tpu_values(name)[3]


def test_state_and_estimates():
    """The state's bonds and dense form, the fidelity estimate, the
    marginals and the permuted state of CircuitPermMPS."""
    j, t = _pair("CircuitMPS")
    psi = t.psi
    assert isinstance(psi, tc.MatrixProductState)
    assert psi.bond_sizes() == j.psi.bond_sizes()
    v = _n(t.to_dense()).reshape(-1)
    np.testing.assert_allclose(v, _n(j.to_dense()).reshape(-1), atol=1e-12)
    assert t.fidelity_estimate() == pytest.approx(j.fidelity_estimate(),
                                                  abs=1e-12)
    assert t.error_estimate() == pytest.approx(1 - t.fidelity_estimate())
    p = t.compute_marginal((1, 4), fix={0: 1})
    want = np.abs(v.reshape((2,) * N)[1]) ** 2
    want = want.sum(axis=tuple(i for i in range(N - 1) if i not in (0, 3)))
    np.testing.assert_allclose(p, want.reshape(-1), atol=1e-12)
    samples = list(t.sample_chaotic(3, (0, 1), seed=2))
    assert samples == list(j.sample_chaotic(3, (0, 1), seed=2))
    np.testing.assert_allclose(_n(t.schrodinger_contract()).reshape(-1), v)
    with pytest.raises(NotImplementedError):
        t.uni
    jp, tp = _pair("CircuitPermMPS")
    assert tp.qubit_perm == jp.qubit_perm
    np.testing.assert_allclose(_n(tp.to_dense()).reshape(-1), v,
                               atol=1e-12)
    np.testing.assert_allclose(_n(tp.get_psi().to_dense()).reshape(-1), v,
                               atol=1e-12)
    assert tp.get_psi_unordered().L == N


def test_lazy_flush_and_options():
    """CircuitMPSLazy queues neighbouring gates until ``flush_every`` and
    compresses them by zip-up; a long-range gate flushes first."""
    circ = quimb_torch.CircuitMPSLazy(4, flush_every=3, device=CPU)
    ref = quimb_torch.CircuitMPS(4, device=CPU)
    for c in (circ, ref):
        c.apply_gate("H", 0)
        c.apply_gate("CNOT", 0, 1)
    assert len(circ._queue) == 2
    circ.apply_gate("CNOT", 0, 3)
    ref.apply_gate("CNOT", 0, 3)
    assert circ._queue == []
    circ.max_bond, circ.cutoff, circ.method = 8, 1e-12, "zipup"
    assert circ.gate_opts["max_bond"] == 8 and circ.method == "zipup"
    for c in (circ, ref):
        c.apply_gate("RZ", 0.3, 2)
        c.apply_gate("CZ", 2, 3)
    np.testing.assert_allclose(_n(circ.get_psi().to_dense()),
                               _n(ref.psi.to_dense()), atol=1e-12)


@pytest.mark.parametrize("qubits", ["q[0],q[2],q[4]", "q[4],q[0],q[2]",
                                    "q[1],q[2],q[3]"])
def test_three_qubit_gate(qubits):
    """A Toffoli on qubits apart or together, in either order: swapped
    together, split back by SVDs, swapped back; against quimb_tpu's exact
    lazy ``Circuit`` (quimb_tpu's CircuitMPS never ends gathering
    q[0], q[2], q[4], ROADMAP §3)."""
    qasm = ("OPENQASM 2.0;\ninclude \"qelib1.inc\";\nqreg q[5];\n"
            "h q[0];\nh q[2];\nx q[3];\n"
            f"ccx {qubits};\ncx q[4],q[1];\n")
    j = qtn.Circuit.from_openqasm2_str(qasm, dtype="complex128")
    t = quimb_torch.CircuitMPS.from_openqasm2_str(qasm, dtype="complex128",
                                                  device=CPU)
    np.testing.assert_allclose(_n(t.to_dense()), _n(j.to_dense()),
                               atol=1e-14)


@pytest.mark.parametrize("gate", [
    ("H", (), (2,), ()), ("X", (), (3,), (1,)),
    ("CZ", (), (0, 2), ()), ("RZZ", (0.4,), (1, 3), ()),
    ("X", (), (4,), (0, 2)), ("SWAP", (), (3, 0), ()),
], ids=["H", "CX", "CZ", "RZZ", "CCX", "SWAP"])
def test_gate_build_mpo(gate):
    """``Gate.build_mpo`` on a 5-site chain against the dense gate on its
    qubits, and against quimb_tpu's."""
    label, params, qubits, controls = gate
    g = Gate(label, params, qubits, controls=controls)
    got = g.build_mpo(L=5, device=CPU)
    assert isinstance(got, tc.MatrixProductOperator) and got.L == 5
    qs = (*controls, *qubits)
    n = len(qs)
    x = np.moveaxis(np.eye(32).reshape((2,) * 5 + (32,)), qs, range(n))
    x = (_n(g.build_array()) @ x.reshape(2**n, -1)).reshape(x.shape)
    dense = np.moveaxis(x, range(n), qs).reshape(32, 32)
    np.testing.assert_allclose(_n(got.to_dense()), dense, rtol=0,
                               atol=1e-14)
    if n > 1:
        # quimb_tpu's fails on a one-qubit gate (ROADMAP §3)
        jg = qtn.circuit.Gate(label, params, qubits, controls=controls)
        np.testing.assert_allclose(_n(got.to_dense()),
                                   _n(jg.build_mpo(L=5).to_dense()),
                                   rtol=0, atol=1e-14)
