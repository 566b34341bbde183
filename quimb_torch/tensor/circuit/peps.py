"""PEPS-based circuit simulation (port of quimb_tpu's
``tensor/circuit/peps.py``, reference ``quimb/tensor/circuit/peps.py``
``CircuitPEPS`` :20): gates applied to a PEPS on a 2D lattice with a
bounded bond dimension, by reduce-split on the circuit's device (the GPU
unless the caller names another)."""

import numbers

from ...config import get_default_dtype
from ...ops.backend import resolve_device, to_device, to_torch_dtype
from ..tn2d.builders import PEPS_computational_state
from .core import CircuitBase


class CircuitPEPS(CircuitBase):
    """Simulate a circuit on an Lx x Ly qubit grid as a PEPS with
    bounded bond dimension (qubit q at coo (q // Ly, q % Ly))."""

    def __init__(self, Lx, Ly=None, psi0=None, max_bond=4, cutoff=1e-10,
                 chi=None, gate_opts=None, tags=None, dtype=None,
                 device=None):
        if Ly is None:
            Ly = Lx
        self.Lx, self.Ly = Lx, Ly
        gate_opts = dict(gate_opts or {})
        gate_opts.setdefault("max_bond", max_bond)
        gate_opts.setdefault("cutoff", cutoff)
        self._chi = chi or max(8, 2 * max_bond**2)
        self.device = resolve_device(device)
        if psi0 is None:
            psi0 = PEPS_computational_state(
                "0" * (Lx * Ly), Lx=Lx, Ly=Ly, device=self.device,
            )
        self.N = Lx * Ly
        # circuits need a complex working dtype regardless of the
        # (real) default of the PEPS builders
        self.dtype = to_torch_dtype(dtype or get_default_dtype())
        self._psi = psi0.copy().astype_(self.dtype)
        self._psi.apply_to_arrays(
            lambda a: to_device(a, device=self.device))
        self.gate_opts = gate_opts
        self._gates = []
        self._storage = {}
        self._sample_n_gates = -1
        self._named_params = {}
        self._named_param_exprs = {}
        self._tags = tags

    def qubit_coo(self, q):
        return (q // self.Ly, q % self.Ly)

    def _apply_array(self, U, where, tags=None, **opts):
        opts = {**self.gate_opts, **opts}
        opts.pop("contract", None)
        coos = [self.qubit_coo(q) for q in where]
        if len(coos) == 1:
            self._psi.gate_(U, coos, contract=True)
            return
        if len(coos) != 2:
            raise ValueError("CircuitPEPS supports 1-/2-qubit gates")
        (i1, j1), (i2, j2) = coos
        if abs(i1 - i2) + abs(j1 - j2) != 1:
            raise ValueError(
                "CircuitPEPS gates must act on lattice-adjacent qubits"
            )
        self._psi.gate_(U, tuple(coos), contract="reduce-split",
                        **opts)

    @property
    def psi(self):
        return self._psi.copy()

    def to_dense(self, **kwargs):
        return self._psi.to_dense()

    def amplitude(self, b, max_bond=None, **kwargs):
        """The amplitude <b|psi> by boundary contraction, a Python
        complex."""
        if isinstance(b, str):
            b = tuple(int(x) for x in b)
        psi = self._psi.copy()
        for q in range(self.N):
            coo = self.qubit_coo(q)
            ind = psi.site_ind(*coo)
            tid = next(iter(psi.ind_map[ind]))
            psi.tensor_map[tid].isel_({ind: int(b[q])})
        psi.view_like_(self._psi)
        return complex(psi.contract_boundary(
            max_bond=max_bond or self._chi, **kwargs
        ))

    def local_expectation(self, G, where, **kwargs):
        if isinstance(where, numbers.Integral):
            where = (where,)
        coos = tuple(self.qubit_coo(q) for q in where)
        return self._psi.compute_local_expectation(
            {coos: G}, max_bond=self._chi, **kwargs
        )


# -- parity extras (reference peps.py:251-330) ------------------------------

def _cpeps_equilibrate(self, **gauge_opts):
    """Re-gauge the state with the simple-update rule — the
    represented state is unchanged, only better conditioned
    (reference ``equilibrate`` peps.py:251)."""
    gauge_opts.setdefault("max_iterations", 5)
    gauges = {}
    self._psi.gauge_all_simple_(gauges=gauges, **gauge_opts)
    self._psi.gauge_simple_insert(gauges)
    return self


def _cpeps_get_state(self, absorb_gauges=True):
    """The current PEPS state (gauges are kept absorbed here, so this
    is simply a copy; reference ``get_state`` peps.py:322)."""
    return self._psi.copy()


CircuitPEPS.equilibrate = _cpeps_equilibrate
CircuitPEPS.get_state = _cpeps_get_state
CircuitPEPS.get_psi = lambda self: self._psi.copy()

# the reference names this class ``CircuitPEPSSimpleUpdate``
CircuitPEPSSimpleUpdate = CircuitPEPS
