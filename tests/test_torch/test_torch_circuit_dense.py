"""quimb_torch's ``CircuitDense`` against quimb_tpu's, on the CPU in
complex128: the same gates (quimb_tpu's brickwork ansatz carried across by
``convert.from_tpu_gates``, and gates on non-neighbouring and reversed
qubits, three-qubit gates and gates at both ends, which take each of the
port's three routes) give the same state, amplitudes, reduced density
matrices and local expectations to 1e-12, and the same strings from
``sample(seed)``: both draw with ``default_rng(seed).choice`` over |psi|^2.
At 12 qubits the dense state equals the port's lazy ``Circuit``."""

import numpy as np
import pytest
import torch

import quimb_tpu.tensor as jtn
import quimb_tpu.tensor.circuit_gen as jgen
import quimb_torch.tensor as ttn
from quimb_torch import convert
from quimb_torch.tensor.tn1d.builders import MPS_rand_state

CPU = "cpu"
TOL = 1e-12


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


EXTRA = (("CNOT", 5, 2), ("CCNOT", 6, 1, 3), ("H", 9), ("RZ", 0.3, 0),
         ("SWAP", 9, 0), ("CZ", 3, 4))


def _circuits(n=10, depth=4):
    """The brickwork's gates on both dense simulators, then (at 10 qubits)
    the gates of ``EXTRA`` on each."""
    j = jgen.circ_ansatz_1D_brickwork(n, depth, seed=7)
    gates = convert.from_tpu_gates(j.gates)
    jd = jtn.CircuitDense(n)
    jd.apply_gates(j.gates)
    td = ttn.CircuitDense(n, device=CPU)
    td.apply_gates(gates)
    if n == 10:
        for g in EXTRA:
            jd.apply_gate(*g)
            td.apply_gate(*g)
    return td, jd, gates


def test_state_amplitudes_and_samples():
    td, jd, _ = _circuits()
    np.testing.assert_allclose(_np(td.psi), np.asarray(jd.psi), rtol=0,
                               atol=TOL)
    assert td.to_dense().shape == (2**10, 1)
    for b in ("0000000000", "0110100101", (1,) * 10):
        assert td.amplitude(b) == pytest.approx(complex(jd.amplitude(b)),
                                                abs=TOL)
    assert list(td.sample(20, seed=42)) == list(jd.sample(20, seed=42))


def test_partial_trace_and_local_expectation():
    td, jd, _ = _circuits()
    for keep in ((2, 7), 4, (0, 9), (3, 4, 5)):
        np.testing.assert_allclose(_np(td.partial_trace(keep)),
                                   np.asarray(jd.partial_trace(keep)),
                                   rtol=0, atol=TOL)
    Z = np.diag([1.0, -1.0])
    rng = np.random.default_rng(0)
    G = rng.standard_normal((4, 4))
    for g, where in ((np.kron(Z, Z), (4, 5)), (G + G.T, (1, 8)), (Z, 3)):
        assert complex(td.local_expectation(g, where)) == pytest.approx(
            complex(jd.local_expectation(g, where)), abs=TOL)


def test_views_and_non_product_start():
    td, _, gates = _circuits(6, 2)
    psi = td.get_psi()
    np.testing.assert_allclose(_np(psi.to_dense()).ravel(),
                               _np(td.psi).ravel(), atol=TOL)
    assert td.get_psi_reverse_lightcone((0,)) is not None
    with pytest.raises(NotImplementedError):
        td.get_uni()
    # an entangled start state: its dense form, then the same gates, as
    # the lazy circuit from the same state
    p0 = MPS_rand_state(6, 3, seed=4, device=CPU)
    a = ttn.CircuitDense(psi0=p0, device=CPU)
    a.apply_gates(gates)
    b = ttn.Circuit(psi0=p0, device=CPU)
    b.apply_gates(gates)
    np.testing.assert_allclose(_np(a.psi), _np(b.to_dense()), atol=TOL)


def test_dense_against_the_lazy_circuit_at_12_qubits():
    j = jgen.circ_ansatz_1D_brickwork(12, 6, seed=3)
    gates = convert.from_tpu_gates(j.gates)
    td = ttn.CircuitDense(12, device=CPU)
    td.apply_gates(gates)
    lazy = ttn.Circuit(12, device=CPU)
    lazy.apply_gates(gates)
    np.testing.assert_allclose(_np(td.psi), _np(lazy.to_dense()), rtol=0,
                               atol=TOL)
    assert float(torch.linalg.norm(td.psi)) == pytest.approx(1.0, abs=1e-13)
