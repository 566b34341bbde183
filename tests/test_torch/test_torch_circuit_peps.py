"""quimb_torch's ``CircuitPEPS`` (``tensor/circuit/peps.py``) and
``CircuitSimpleUpdate`` (``simple_update.py``) against quimb_tpu's and
against the port's exact ``Circuit``, in complex128 on the CPU.

Both circuits apply one list of gates drawn from a seeded numpy stream
(one-qubit ``U3`` on every qubit, then ``CZ`` on nearest-neighbour pairs).
The PEPS's bond limit is high enough to keep it exact, so its amplitudes
equal the exact circuit's. Tolerance: 1e-12 absolute on amplitudes of
size ~2^-n/2, 1e-10 relative on expectations.
"""

import numpy as np
import pytest
import torch

import quimb_tpu.tensor as jtn
import quimb_torch.tensor as ttn

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gates(Lx, Ly, depth, seed):
    """``depth`` layers of U3 on every qubit and CZ on every lattice bond
    (qubit q at (q // Ly, q % Ly))."""
    rng = np.random.default_rng(seed)
    n = Lx * Ly
    bonds = [(i * Ly + j, i * Ly + j + 1) for i in range(Lx)
             for j in range(Ly - 1)]
    bonds += [(i * Ly + j, (i + 1) * Ly + j) for i in range(Lx - 1)
              for j in range(Ly)]
    gates = []
    for _ in range(depth):
        gates += [("U3", *rng.uniform(0, 2 * np.pi, 3), q) for q in range(n)]
        gates += [("CZ", a, b) for a, b in bonds]
    return gates


def _bits(n, k, seed):
    rng = np.random.default_rng(seed)
    return ["0" * n] + ["".join(rng.choice(["0", "1"], size=n))
                        for _ in range(k - 1)]


@pytest.mark.parametrize("Lx,Ly,depth", [(2, 3, 2), (3, 3, 2)])
def test_amplitudes_match(Lx, Ly, depth):
    gates = _gates(Lx, Ly, depth, seed=Lx + Ly)
    cp = ttn.CircuitPEPS(Lx, Ly, max_bond=32, cutoff=0.0, device=CPU)
    jp = jtn.CircuitPEPS(Lx, Ly, max_bond=32, cutoff=0.0)
    exact = ttn.Circuit(N=Lx * Ly, device=CPU)
    for c in (cp, jp, exact):
        c.apply_gates(gates)
    assert cp.num_gates == len(gates) and cp.N == Lx * Ly
    assert all(t.data.dtype == torch.complex128 for t in cp.psi)
    for b in _bits(Lx * Ly, 4, seed=1):
        a = cp.amplitude(b, cutoff=0.0)
        assert isinstance(a, complex)
        assert abs(a - complex(exact.amplitude(b))) < 1e-12
        assert abs(a - complex(jp.amplitude(b, cutoff=0.0))) < 1e-12


def test_dense_state_matches():
    gates = _gates(2, 2, 2, seed=3)
    cp = ttn.CircuitPEPS(2, max_bond=16, cutoff=0.0, device=CPU)
    exact = ttn.Circuit(N=4, device=CPU)
    cp.apply_gates(gates)
    exact.apply_gates(gates)
    got = cp.to_dense().reshape(-1).numpy()
    want = exact.to_dense().reshape(-1).numpy()
    assert np.allclose(got, want, atol=1e-12)


def test_local_expectation_matches():
    """A one- and a two-site expectation equal quimb_tpu's."""
    gates = _gates(2, 3, 2, seed=4)
    cp = ttn.CircuitPEPS(2, 3, max_bond=16, cutoff=0.0, device=CPU)
    jp = jtn.CircuitPEPS(2, 3, max_bond=16, cutoff=0.0)
    cp.apply_gates(gates)
    jp.apply_gates(gates)
    Z = np.diag([1.0, -1.0]).astype(complex)
    for G, where in ((Z, 1), (np.kron(Z, Z), (1, 4))):
        got = complex(cp.local_expectation(G, where))
        want = complex(jp.local_expectation(G, where))
        assert abs(got - want) <= 1e-10 * max(abs(want), 1e-3)


def test_gates_on_far_qubits_are_refused():
    cp = ttn.CircuitPEPS(3, device=CPU)
    with pytest.raises(ValueError, match="lattice-adjacent"):
        cp.apply_gate("CZ", 0, 4)
    with pytest.raises(ValueError, match="1-/2-qubit"):
        cp.apply_gate("CCZ", 0, 1, 2)


def test_state_access_and_equilibrate():
    """``psi``, ``get_state`` and ``get_psi`` are copies; ``equilibrate``
    re-gauges without changing the state."""
    cp = ttn.CircuitPEPS(2, max_bond=8, cutoff=0.0, device=CPU)
    cp.apply_gates(_gates(2, 2, 1, seed=5))
    before = cp.to_dense().reshape(-1).numpy()
    for psi in (cp.psi, cp.get_state(), cp.get_psi()):
        assert psi is not cp._psi and isinstance(psi, ttn.PEPS)
    cp.equilibrate()
    after = cp.to_dense().reshape(-1).numpy()
    assert np.allclose(after, before, atol=1e-12)
    assert ttn.CircuitPEPSSimpleUpdate is ttn.CircuitPEPS


@pytest.mark.parametrize("method", ["amplitude", "partial_trace",
                                    "compute_marginal", "sample",
                                    "sample_chaotic", "get_edges"])
def test_circuit_simple_update_base_raises(method):
    base = object.__new__(ttn.CircuitSimpleUpdate)
    base.N = 3
    assert base.sites == (0, 1, 2)
    assert base.calc_qubit_ordering((2, 0)) == (0, 2)
    with pytest.raises(NotImplementedError):
        getattr(base, method)()


def test_defaults_to_the_gpu():
    """With no ``device`` the state goes to the GPU; with no GPU the
    circuit raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        assert all(t.data.is_cuda for t in ttn.CircuitPEPS(2).psi)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttn.CircuitPEPS(2)
