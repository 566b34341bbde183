"""quimb_torch's Heisenberg-picture PEPO simulator
(``tensor/circuit/pepo.py``: ``CircuitPEPOSimpleUpdate``) against
quimb_tpu's and against the port's exact ``Circuit``, in complex128 on the
CPU.

The circuit is a 3 x 3 grid, two layers of seeded U3 gates and CZ on every
bond (the pattern of ``chip_smoke.py``'s 4 x 4 circuit). At a bond limit
that keeps the backward evolution exact, every <Z_q> agrees with the exact
circuit to 1e-10; at a truncating bond the two packages agree with each
other to 1e-10 (the same splits of O(1) numbers).
"""

import numpy as np
import pytest
import torch

import quimb_tpu.tensor as jtn
import quimb_torch.tensor as ttn
from quimb_torch.tensor.circuit import pepo as tpepo
from quimb_tpu.ops.contraction import contract_backend as jbackend

CPU = "cpu"
Z = np.diag([1.0, -1.0])
L = 3


@pytest.fixture(autouse=True)
def _one_thread_host_reference():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with jbackend("numpy"):
        yield
    torch.set_num_threads(n)


def _gates(depth=2, seed=7):
    rng = np.random.default_rng(seed)
    n = L * L
    pairs = [[], [], [], []]
    for i in range(L):
        for j in range(L):
            q = i * L + j
            if j + 1 < L:
                pairs[j % 2].append((q, q + 1))
            if i + 1 < L:
                pairs[2 + i % 2].append((q, q + L))
    gates = []
    for _ in range(depth):
        gates += [("U3", *rng.uniform(0, 2 * np.pi, 3), q) for q in range(n)]
        gates += [("CZ", *pq) for cls in pairs for pq in cls]
    return gates


def _z(circ, qubits):
    return np.array([complex(circ.local_expectation(Z, q)).real
                     for q in qubits])


def test_exact_bond_matches_circuit():
    gates = _gates()
    n = L * L
    cp = ttn.CircuitPEPOSimpleUpdate(N=n, max_bond=16, device=CPU)
    cp.apply_gates(gates)
    assert all(U.device.type == "cpu" and U.dtype == torch.complex128
               for U, _ in cp._recorded)
    exact = ttn.Circuit(N=n, device=CPU)
    exact.apply_gates(gates)
    got = _z(cp, range(n))
    np.testing.assert_allclose(got, _z(exact, range(n)), rtol=0, atol=1e-10)
    jc = jtn.CircuitPEPOSimpleUpdate(N=n, max_bond=16)
    jc.apply_gates(gates)
    np.testing.assert_allclose(got, _z(jc, range(n)), rtol=0, atol=1e-10)
    assert cp.N == n and cp.max_bond == 16
    assert sorted(cp.get_edges()) == sorted(jc.get_edges())


def test_truncating_bond_matches_quimb_tpu():
    gates = _gates()
    n = L * L
    cp = ttn.CircuitPEPOSimpleUpdate(N=n, max_bond=2, device=CPU)
    cp.apply_gates(gates)
    jc = jtn.CircuitPEPOSimpleUpdate(N=n, max_bond=2)
    jc.apply_gates(gates)
    qubits = (0, 4, 8)
    np.testing.assert_allclose(_z(cp, qubits), _z(jc, qubits), rtol=0,
                               atol=1e-10)


def test_lightcone_skips_gates(monkeypatch):
    """Gates outside the observable's reverse lightcone are never applied
    (G^dagger G = 1): a Z on qubit 0 after gates on qubits 4 and 5 only
    costs the observable's placement and gives <0|Z|0> = 1; each gate
    inside the cone is applied twice (upper and lower indices)."""
    calls = []
    gate_inds = tpepo.tensor_network_gate_inds

    def counted(*args, **kwargs):
        calls.append(args[2])
        return gate_inds(*args, **kwargs)

    monkeypatch.setattr(tpepo, "tensor_network_gate_inds", counted)
    cp = ttn.CircuitPEPOSimpleUpdate(N=L * L, max_bond=4, device=CPU)
    cp.apply_gates([("H", 4), ("CNOT", 4, 5), ("RX", 0.3, 5)])
    assert complex(cp.local_expectation(Z, 0)) == pytest.approx(1.0,
                                                                abs=1e-12)
    assert calls == []
    cp.apply_gates([("H", 0), ("CNOT", 0, 1)])
    calls.clear()
    val = complex(cp.local_expectation(Z, 1)).real
    assert len(calls) == 4
    exact = ttn.Circuit(N=L * L, device=CPU)
    exact.apply_gates([("H", 4), ("CNOT", 4, 5), ("RX", 0.3, 5), ("H", 0),
                       ("CNOT", 0, 1)])
    assert val == pytest.approx(complex(exact.local_expectation(Z, 1)).real,
                                abs=1e-12)


def test_evolved_operator_with_state():
    gates = _gates(depth=1)
    cp = ttn.CircuitPEPOSimpleUpdate(N=L * L, max_bond=8, device=CPU)
    cp.apply_gates(gates)
    tn = cp.get_evolved_operator_with_state(Z, 4)
    assert complex(tn.contract(...)) == pytest.approx(
        complex(cp.local_expectation(Z, 4)), abs=1e-12)
    op = cp.get_evolved_operator(Z, 4)
    assert type(op).__name__ == "TensorNetworkGenOperator"
    for name in ("get_psi", "to_dense"):
        with pytest.raises(NotImplementedError, match="Heisenberg"):
            getattr(cp, name)()
