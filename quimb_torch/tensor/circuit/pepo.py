"""Heisenberg-picture PEPO circuit simulation (port of quimb_tpu's
``tensor/circuit/pepo.py``, reference ``quimb/tensor/circuit/pepo.py``
``CircuitPEPOSimpleUpdate`` :18).

Gates are only *recorded* as applied; when a local expectation is
requested the observable is built as a bond-1 operator TN on the
circuit's interaction graph and evolved **backwards**
(:math:`O \\rightarrow G^\\dagger O G`) through the reverse lightcone
with bounded-bond (simple-update-style reduce-split) compression,
finally projected onto :math:`|00\\ldots0\\rangle`. The gates are
recorded on the circuit's device (the GPU unless the caller names
another), and the operator evolves there.
"""

import collections
import numbers

import torch

from ...config import get_default_dtype
from ...ops.backend import resolve_device, to_device, to_torch_dtype
from ..core import Tensor, TensorNetwork, rand_uuid
from ..gating import tensor_network_gate_inds
from ..tnag.core import TensorNetworkGenOperator
from .core import CircuitBase


class CircuitPEPOSimpleUpdate(CircuitBase):
    """Evolve observables backwards through a circuit as an
    arbitrary-geometry PEPO with simple-update-style bounded-bond gate
    application (reference ``CircuitPEPOSimpleUpdate``
    circuit/pepo.py:18). Gates outside the observable's reverse
    lightcone are skipped (:math:`G^\\dagger G = 1`)."""

    def __init__(self, N=None, edges=None, gates=None, max_bond=4,
                 cutoff=1e-10, gate_opts=None, tags=None, dtype=None,
                 device=None):
        self.device = resolve_device(device)
        self.dtype = to_torch_dtype(dtype or get_default_dtype())
        self._edges = (
            tuple(tuple(e) for e in edges) if edges is not None
            else None
        )
        self.gate_opts = dict(gate_opts or {})
        self.gate_opts.setdefault("max_bond", max_bond)
        self.gate_opts.setdefault("cutoff", cutoff)
        self.gates = []
        self._storage = {}
        self._sample_n_gates = -1
        self._named_params = {}
        self._named_param_exprs = {}
        self._recorded = []
        self._tags = tags
        self._N = N
        if gates is not None:
            self.apply_gates(gates)

    @property
    def N(self):
        if self._N is not None:
            return self._N
        sites = {q for _, w in self._recorded for q in w}
        return (max(sites) + 1) if sites else 0

    @N.setter
    def N(self, value):
        self._N = value

    def _apply_array(self, U, where, tags=None, **opts):
        # Heisenberg picture: gates are recorded, not applied
        self._recorded.append((to_device(U, device=self.device),
                               tuple(where)))

    def get_edges(self):
        """The interaction graph: supplied ``edges`` or inferred from
        the recorded two-qubit gates."""
        if self._edges is not None:
            return self._edges
        edges = []
        seen = set()
        for _, where in self._recorded:
            if len(where) == 2:
                key = tuple(sorted(where))
                if key not in seen:
                    seen.add(key)
                    edges.append(key)
        return tuple(edges)

    def _identity_operator_tn(self, sites, edges):
        """Bond-1 PEPO: identity at every site, dim-1 bonds along
        ``edges``."""
        bond = collections.defaultdict(rand_uuid)
        ts = []
        for site in sites:
            inds = []
            for a, b in edges:
                if site in (a, b):
                    inds.append(bond[tuple(sorted((a, b)))])
            data = torch.eye(2, dtype=self.dtype, device=self.device
                             ).reshape((1,) * len(inds) + (2, 2))
            ts.append(Tensor(
                data, inds=(*inds, f"k{site}", f"b{site}"),
                tags=(f"I{site}",),
            ))
        tn = TensorNetwork(ts, virtual=True)
        return tn.view_as_(
            TensorNetworkGenOperator, sites=tuple(sites),
            site_tag_id="I{}", upper_ind_id="k{}", lower_ind_id="b{}",
        )

    def get_evolved_operator(self, G, where, **opts):
        """Evolve local observable ``G`` at ``where`` backwards through
        the recorded gates, returning the (compressed) operator TN."""
        if isinstance(where, numbers.Integral):
            where = (where,)
        where = tuple(where)
        opts = {**self.gate_opts, **opts}

        edges = self.get_edges()
        sites = sorted(
            {q for e in edges for q in e}
            | set(where)
            | set(range(self.N))
        )
        O = self._identity_operator_tn(sites, edges)

        # place the observable
        G = to_device(G, device=self.device, dtype=self.dtype)
        O.gate_inds_(
            G, tuple(f"k{q}" for q in where),
            contract=True if len(where) == 1 else "reduce-split",
            **({} if len(where) == 1 else opts),
        )

        active = set(where)
        for U, w in reversed(self._recorded):
            if not (set(w) & active):
                # outside the reverse lightcone: G†G = 1
                continue
            active.update(w)
            Ud = U.mH
            Ut = U.mT
            contract = True if len(w) == 1 else "reduce-split"
            kw = {} if len(w) == 1 else opts
            # O -> U† O U
            tensor_network_gate_inds(
                O, Ud, tuple(f"k{q}" for q in w), contract=contract,
                inplace=True, **kw,
            )
            tensor_network_gate_inds(
                O, Ut, tuple(f"b{q}" for q in w), contract=contract,
                inplace=True, **kw,
            )
        return O

    def local_expectation(self, G, where, **opts):
        """``<00...0| U† G_where U |00...0>`` via backwards evolution
        of ``G``."""
        O = self.get_evolved_operator(G, where, **opts)
        # project onto |0...0> on both sides
        zero = torch.tensor([1.0, 0.0], dtype=self.dtype, device=self.device)
        for ix in tuple(O.outer_inds()):
            O.add_tensor(Tensor(zero, inds=(ix,)), virtual=True)
        val = O.contract(output_inds=())
        return val.item() if isinstance(val, torch.Tensor) else val


__all__ = ["CircuitPEPOSimpleUpdate"]


# -- parity extras (reference pepo.py:118-360) ------------------------------

def _cpepo_unsupported(self, name):
    raise NotImplementedError(
        f"CircuitPEPOSimpleUpdate evolves operators backwards "
        f"(Heisenberg picture) — '{name}' has no state to act on"
    )


def _cpepo_get_evolved_operator_with_state(self, G, where, *,
                                           max_bond=None, cutoff=None):
    """The evolved operator ``U† G U`` projected onto ``|00...0>`` on
    both sides: contracting the returned TN gives ``<0|U† G U|0>``
    (reference ``get_evolved_operator_with_state`` pepo.py:287)."""
    opts = {}
    if max_bond is not None:
        opts["max_bond"] = max_bond
    if cutoff is not None:
        opts["cutoff"] = cutoff
    op = self.get_evolved_operator(G, where, **opts)
    sel = {}
    for s in op.sites:
        for ix in (op.upper_ind(s), op.lower_ind(s)):
            if ix in op.ind_map:
                sel[ix] = 0
    return op.isel(sel)


CircuitPEPOSimpleUpdate.max_bond = property(
    lambda self: self.gate_opts.get("max_bond"),
    lambda self, v: self.gate_opts.__setitem__("max_bond", v),
)
CircuitPEPOSimpleUpdate.cutoff = property(
    lambda self: self.gate_opts.get("cutoff"),
    lambda self, v: self.gate_opts.__setitem__("cutoff", v),
)
CircuitPEPOSimpleUpdate.get_psi = \
    lambda self: _cpepo_unsupported(self, "psi")
CircuitPEPOSimpleUpdate.to_dense = \
    lambda self, *a, **k: _cpepo_unsupported(self, "to_dense")
CircuitPEPOSimpleUpdate.get_evolved_operator_with_state = \
    _cpepo_get_evolved_operator_with_state
