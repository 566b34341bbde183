"""Shared base for simple-update-style circuit simulators on arbitrary
geometries (port of quimb_tpu's ``tensor/circuit/simple_update.py``,
reference ``CircuitSimpleUpdate`` circuit/simple_update.py:8)."""

from .core import CircuitBase


class CircuitSimpleUpdate(CircuitBase):
    """Base class for circuit simulators that apply gates with the
    simple-update rule on an arbitrary interaction geometry. Exact
    amplitude/marginal extraction is not generally available — the
    concrete subclasses provide what their representation supports."""

    @property
    def edges(self):
        """The interaction graph edges."""
        return self.get_edges()

    @property
    def sites(self):
        """The qubit sites."""
        return tuple(range(self.N))

    def get_edges(self):
        raise NotImplementedError

    def calc_qubit_ordering(self, qubits=None):
        if qubits is None:
            return tuple(range(self.N))
        return tuple(sorted(qubits))

    @property
    def uni(self):
        raise NotImplementedError(
            "simple-update circuit simulators do not track the "
            "unitary TN"
        )

    def amplitude(self, *args, **kwargs):
        raise NotImplementedError

    def partial_trace(self, *args, **kwargs):
        raise NotImplementedError

    def compute_marginal(self, *args, **kwargs):
        raise NotImplementedError

    def sample(self, *args, **kwargs):
        raise NotImplementedError

    def sample_chaotic(self, *args, **kwargs):
        raise NotImplementedError
