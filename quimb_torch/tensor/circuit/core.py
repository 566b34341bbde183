"""Quantum circuit simulation via tensor networks.

Port of quimb_tpu's ``tensor/circuit/core.py`` to torch (reference
``quimb/tensor/circuit/``: ``CircuitBase`` core.py:49 with ~80 named gate
methods; the exact lazy-TN ``Circuit`` exact.py:38 with reverse-lightcone
extraction :215,271, ``amplitude`` :417, marginal-cached ``sample``
:1135, ``local_expectation`` :659, ``to_dense`` :1851).

Where the work runs. The lazy network keeps host numpy leaves while gates
are appended and while ``full_simplify`` rewrites it: that is graph
surgery on 2x2 and 2x2x2x2 tensors. Every contraction that yields a
returned quantity (an amplitude, a reduced density matrix, a marginal, the
dense state) moves its operands to ``circ.device`` in one transfer and
runs there, as a chain of pairwise products; ``backend="numpy"`` asks for
the host instead. The cached marginal expressions keep their arrays on the
device in complex128 (quimb_tpu's host contraction dtype), and each group
of a sample moves only its bit vectors there; the probabilities come back
to the host in float64 for ``rng.choice``.
"""

import inspect
import math
import numbers

import numpy as np
import torch

from ...config import DEFAULT_DTYPE
from ...ops.backend import (
    numpy_dtype,
    resolve_device,
    to_device,
    to_host,
    to_torch_dtype,
)
from ...ops.contraction import array_contract_expression, contract_backend
from ...utils import LRU, oset
from ..core import Tensor, TensorNetwork, rand_uuid
from ..gating import tensor_network_gate_inds
from ..tn1d.builders import MPS_computational_state
from .gates import PARAM_GATES, Gate

# The cached marginal expressions are used while their log2 width and
# flops stay within these limits; beyond them ``compute_marginal``
# re-simplifies the network for each sample's fixed bits. Both routes are
# exact: the limits choose between them, never the result.
_EXPR_WIDTH_LIMIT = 24
_EXPR_FLOPS_LIMIT = 3e7
# the simplify sequence run after fixing a sample's bits: the region
# network was fully simplified with open outputs already
_POST_FIX_SIMPLIFY = "R"


def _collapse_repeats(a, term):
    """Collapse repeated indices of a single tensor to their diagonal
    (host, build-time) so contraction *expressions* — which assume
    unique labels per input — can be built over bra=ket-merged
    networks."""
    if len(set(term)) == len(term):
        return a, term
    letters = {}
    for ix in term:
        if ix not in letters:
            letters[ix] = chr(97 + len(letters))
    lhs = "".join(letters[ix] for ix in term)
    out_term = tuple(dict.fromkeys(term))
    rhs = "".join(letters[ix] for ix in out_term)
    return np.einsum(f"{lhs}->{rhs}", a), out_term


def _arrays_to_device(arrays, device, dtype=None):
    """Host arrays (and tensors) -> tensors on ``device``, the host
    arrays carried over in one transfer: they are packed into one buffer
    per dtype, moved, and split into views of the device copy."""
    out = list(arrays)
    groups = {}
    for i, a in enumerate(out):
        if isinstance(a, torch.Tensor):
            out[i] = a.to(device=device, dtype=dtype)
        else:
            a = np.asarray(a)
            if dtype is not None:
                a = a.astype(numpy_dtype(dtype), copy=False)
            out[i] = a
            groups.setdefault(a.dtype, []).append(i)
    for idx in groups.values():
        flat = np.concatenate([out[i].reshape(-1) for i in idx])
        buf = torch.from_numpy(flat).to(device)
        pieces = torch.split(buf, [out[i].size for i in idx])
        for i, piece in zip(idx, pieces):
            out[i] = piece.reshape(out[i].shape)
    return out


def _network_to_device(tn, device):
    """Move every array of ``tn`` to ``device`` in one transfer."""
    ts = tuple(tn.tensor_map.values())
    for t, a in zip(ts, _arrays_to_device([t.data for t in ts], device)):
        t.modify(data=a)
    return tn


def parse_to_gate(gate_id, *gate_args, params=None, qubits=None,
                  controls=None, gate_round=None, parametrize=False):
    """Normalize the many ``apply_gate`` call signatures into a Gate."""
    if isinstance(gate_id, Gate):
        return gate_id
    if hasattr(gate_id, "shape") and not isinstance(gate_id, str):
        # raw array
        return Gate.from_raw(gate_id, qubits or gate_args)
    label = gate_id.upper()
    if label in PARAM_GATES:
        nparams = len(
            inspect.signature(PARAM_GATES[label]).parameters
        )
        if PARAM_GATES[label].__name__ == "su4_gate":
            nparams = 15
    else:
        nparams = 0
    if qubits is not None:
        params = tuple(gate_args) if params is None else tuple(params)
        qubits = tuple(qubits)
    else:
        gate_args = tuple(gate_args)
        if nparams:
            params = gate_args[:nparams]
            qubits = gate_args[nparams:]
        else:
            params = ()
            qubits = gate_args
    return Gate(label, params, qubits, controls=controls,
                round=gate_round, parametrize=parametrize)


class CircuitBase:
    """Shared gate front-end (reference ``CircuitBase``
    circuit/core.py:49).

    ``dtype`` is the state's dtype (complex128 unless given: a torch
    dtype or its name); ``device`` is where the returned quantities are
    computed, the GPU unless the caller names another. Without CUDA a
    circuit built with no device raises.
    """

    def __init__(self, N=None, psi0=None, gate_opts=None, tags=None,
                 dtype=None, device=None):
        self.device = resolve_device(device)
        self.dtype = to_torch_dtype(dtype or DEFAULT_DTYPE)
        if psi0 is None:
            if N is None:
                raise ValueError("supply N or psi0")
            self.N = N
            # the lazy simulators keep host leaves; the MPS ones start on
            # the device
            psi0 = MPS_computational_state(
                "0" * N, dtype=self.dtype,
                device="cpu" if self._host_gate_arrays else self.device)
        else:
            self.N = psi0.L
            psi0 = psi0.copy().astype_(self.dtype)
        self._psi = self._init_state(psi0)
        self.gate_opts = dict(gate_opts or {})
        self._gates = []
        self._tags = tags
        self._storage = {}
        self._sample_n_gates = -1
        self._named_params = {}
        self._named_param_exprs = {}

    def _init_state(self, psi0):
        return psi0

    # -- gate application -----------------------------------------------------

    def apply_gate(self, gate_id, *gate_args, gate_round=None, **opts):
        """Apply a gate: ``circ.apply_gate('H', 0)``,
        ``circ.apply_gate('RX', 0.4, 1)``, a Gate object, or a raw
        array with ``qubits=``."""
        gate = parse_to_gate(gate_id, *gate_args, gate_round=gate_round,
                             **{k: opts.pop(k) for k in
                                ("params", "qubits", "controls",
                                 "parametrize") if k in opts})
        self._apply_gate(gate, **opts)
        return self

    # lazy TN simulators set this True: gate tensors are microscopic
    # and stay as host numpy arrays until the final contraction
    _host_gate_arrays = False

    def _apply_gate(self, gate, **opts):
        tags = [f"GATE_{len(self._gates)}"]
        if gate.round is not None:
            tags.append(f"ROUND_{gate.round}")
        if isinstance(gate.label, str):
            tags.append(gate.label)
        self._gates.append(gate)
        if self._host_gate_arrays:
            U = np.asarray(to_host(gate.build_array()),
                           dtype=numpy_dtype(self.dtype))
        else:
            U = to_device(gate.build_array(), device=self.device,
                          dtype=self.dtype)
        where = (*gate.controls, *gate.qubits)
        self._apply_array(U, where, tags=tags, **opts)

    def _apply_array(self, U, where, tags=None, **opts):
        raise NotImplementedError

    def apply_gates(self, gates, **opts):
        for g in gates:
            if isinstance(g, Gate):
                self._apply_gate(g, **opts)
            else:
                self.apply_gate(*g, **opts)
        return self

    def apply_gate_raw(self, U, where, tags=None, **opts):
        gate = Gate.from_raw(U, where, tags=tags)
        self._apply_gate(gate, **opts)
        return self

    @property
    def gates(self):
        """The gates applied so far, as a tuple (reference
        ``CircuitBase.gates``)."""
        return tuple(self._gates)

    @gates.setter
    def gates(self, gates):
        self._gates = list(gates)

    @property
    def num_gates(self):
        return len(self._gates)

    def copy(self):
        new = object.__new__(self.__class__)
        new.__dict__ = {
            k: (v.copy() if hasattr(v, "copy") else v)
            for k, v in self.__dict__.items()
        }
        new._gates = list(self._gates)
        return new

    # -- index/tag helpers (reference circuit/core.py:557-573) ---------------

    def ket_site_ind(self, i):
        """The site index of qubit ``i``."""
        return f"k{i}"

    def bra_site_ind(self, i):
        """The 'bra' site index of qubit ``i`` when forming an
        operator."""
        return f"b{i}"

    def gate_tag(self, g):
        """The tag of gate number ``g``."""
        return f"GATE_{g}"

    def round_tag(self, r):
        """The tag of round (layer) ``r``."""
        return f"ROUND_{r}"

    @property
    def psi(self):
        """The current state (subclasses return richer views)."""
        return self._psi

    def get_psi(self):
        """A copy of the current state (reference ``get_psi``)."""
        psi = self.psi
        return psi.copy() if hasattr(psi, "copy") else psi

    def calc_qubit_ordering(self, qubits=None, method=None):
        """Default qubit ordering (subclasses refine with lightcone
        information)."""
        if qubits is None:
            return tuple(range(self.N))
        return tuple(sorted(qubits))

    def apply_to_arrays(self, fn):
        """Apply ``fn`` to all state arrays and named parameters
        (reference circuit/core.py:200)."""
        if hasattr(self._psi, "apply_to_arrays"):
            self._psi.apply_to_arrays(fn)
        else:
            self._psi = fn(self._psi)
        self._named_params = {k: fn(v)
                              for k, v in self._named_params.items()}

    def clear_storage(self):
        """Clear cached marginals/samples (reference
        circuit/core.py:1145)."""
        self._storage.clear()
        for attr in ("_sample_cache", "_marginal_cache",
                     "_lightcone_cache", "_region_expr_cache",
                     "_amp_expr"):
            c = getattr(self, attr, None)
            if c is None:
                continue
            if hasattr(c, "clear"):
                c.clear()
            else:
                setattr(self, attr, None)
        self._sample_n_gates = self.num_gates

    def _maybe_init_storage(self):
        if self._sample_n_gates != self.num_gates:
            self.clear_storage()

    def draw(self, **kwargs):
        """Print a text diagram of the circuit gates (the reference
        draws with matplotlib)."""
        for i, g in enumerate(self._gates):
            qubits = ",".join(map(str, (*g.controls, *g.qubits)))
            params = ", ".join(f"{float(p):.3g}" for p in g.params) \
                if g.params else ""
            print(f"{i:>4} {g.label:<10} [{qubits}] {params}")

    # -- named parameters (reference circuit/core.py:214-360) ----------------

    @property
    def named_params(self):
        """Named circuit parameters and their current values."""
        return dict(self._named_params)

    @property
    def named_param_names(self):
        return tuple(self._named_params)

    @property
    def param_expressions(self):
        """Gate parameter expressions keyed by gate index."""
        return dict(self._named_param_exprs)

    def register_named_params(self, named_params, gate_expressions=None):
        """Register named circuit parameters and (optionally) the
        expressions mapping them to gate parameters (reference
        circuit/core.py:228)."""
        if isinstance(named_params, dict):
            self._named_params = dict(named_params)
        else:
            self._named_params = {
                name: float("nan") for name in named_params
            }
        self._named_param_exprs = {
            int(i): tuple(exprs)
            for i, exprs in (gate_expressions or {}).items()
        }

    def _eval_param_expr(self, expr):
        if callable(expr):
            return expr(self._named_params)
        if isinstance(expr, str):
            return eval(expr, {"__builtins__": {}},
                        dict(self._named_params))
        return expr

    def get_params(self):
        """All circuit parameters: named parameters plus directly
        parametrized gate params (reference circuit/core.py:306)."""
        params = dict(self._named_params)
        managed = set(self._named_param_exprs)
        for i, g in enumerate(self._gates):
            if g.parametrize and i not in managed:
                params[i] = g.params
        return params

    def set_params(self, params):
        """Update named and/or per-gate parameters and replay the
        circuit with the new values (reference circuit/core.py:327)."""
        params = dict(params or {})
        for k, v in params.items():
            if isinstance(k, str):
                if k not in self._named_params:
                    raise ValueError(f"unknown named parameter {k!r}")
                self._named_params[k] = v
        gate_updates = {
            k: v for k, v in params.items() if not isinstance(k, str)
        }
        managed_overrides = set(gate_updates) & set(
            self._named_param_exprs
        )
        if managed_overrides:
            raise ValueError(
                "Gates driven by named parameter expressions cannot be "
                f"overridden directly: {sorted(managed_overrides)}"
            )
        new_gates = []
        for i, g in enumerate(self._gates):
            if i in self._named_param_exprs:
                new_p = tuple(
                    self._eval_param_expr(e)
                    for e in self._named_param_exprs[i]
                )
                g = g.copy_with(params=new_p)
            elif i in gate_updates:
                g = g.copy_with(params=tuple(
                    np.atleast_1d(gate_updates[i])
                ))
            new_gates.append(g)
        # replay on a fresh initial state
        fresh = type(self)(N=self.N, gate_opts=self.gate_opts,
                           dtype=self.dtype, device=self.device)
        fresh.register_named_params(
            self._named_params, self._named_param_exprs
        )
        fresh.apply_gates(new_gates)
        self.__dict__.update(fresh.__dict__)
        return self

    def update_params_from(self, other):
        """Copy the parameters of ``other`` (a circuit with matching
        gates) into this circuit (reference
        ``update_params_from``)."""
        self.set_params(other.get_params())
        return self

    @classmethod
    def from_gates(cls, gates, N=None, progbar=False, **kwargs):
        """Build a circuit from a sequence of gates (reference
        circuit/core.py:519)."""
        gates = tuple(gates)
        if N is None:
            N = 0
            for g in gates:
                if not isinstance(g, Gate):
                    g = parse_to_gate(*g) if isinstance(
                        g, (tuple, list)) else parse_to_gate(g)
                N = max((N, *(q + 1 for q in g.qubits),
                         *(c + 1 for c in g.controls)))
        qc = cls(N, **kwargs)
        qc.apply_gates(gates)
        return qc

    # -- named gate methods ---------------------------------------------------

    def _make_gate_method(name):  # noqa: N805
        def meth(self, *args, gate_round=None, **opts):
            return self.apply_gate(name, *args, gate_round=gate_round,
                                   **opts)

        meth.__name__ = name.lower()
        return meth

    h = _make_gate_method("H")
    x = _make_gate_method("X")
    y = _make_gate_method("Y")
    z = _make_gate_method("Z")
    s = _make_gate_method("S")
    sdg = _make_gate_method("SDG")
    t = _make_gate_method("T")
    tdg = _make_gate_method("TDG")
    sx = _make_gate_method("SX")
    sxdg = _make_gate_method("SXDG")
    x_1_2 = _make_gate_method("X_1_2")
    y_1_2 = _make_gate_method("Y_1_2")
    w_1_2 = _make_gate_method("W_1_2")
    hz_1_2 = _make_gate_method("HZ_1_2")
    rx = _make_gate_method("RX")
    ry = _make_gate_method("RY")
    rz = _make_gate_method("RZ")
    u3 = _make_gate_method("U3")
    u2 = _make_gate_method("U2")
    u1 = _make_gate_method("U1")
    p = _make_gate_method("P")
    cnot = _make_gate_method("CNOT")
    cx = _make_gate_method("CX")
    cy = _make_gate_method("CY")
    cz = _make_gate_method("CZ")
    cu3 = _make_gate_method("CU3")
    cu2 = _make_gate_method("CU2")
    cu1 = _make_gate_method("CU1")
    cp = _make_gate_method("CP")
    crx = _make_gate_method("CRX")
    cry = _make_gate_method("CRY")
    crz = _make_gate_method("CRZ")
    swap = _make_gate_method("SWAP")
    iswap = _make_gate_method("ISWAP")
    fsim = _make_gate_method("FSIM")
    fsimg = _make_gate_method("FSIMG")
    givens = _make_gate_method("GIVENS")
    rxx = _make_gate_method("RXX")
    ryy = _make_gate_method("RYY")
    rzz = _make_gate_method("RZZ")
    xx_plus_yy = _make_gate_method("XX_PLUS_YY")
    ccx = _make_gate_method("CCX")
    ccy = _make_gate_method("CCY")
    ccz = _make_gate_method("CCZ")
    cswap = _make_gate_method("CSWAP")
    toffoli = _make_gate_method("TOFFOLI")
    fredkin = _make_gate_method("FREDKIN")
    su4 = _make_gate_method("SU4")
    ccnot = _make_gate_method("CCNOT")
    z_1_2 = _make_gate_method("Z_1_2")
    xx_minus_yy = _make_gate_method("XX_MINUS_YY")
    cphase = _make_gate_method("CPHASE")
    phase = _make_gate_method("PHASE")
    givens2 = _make_gate_method("GIVENS2")
    iden = _make_gate_method("IDEN")

    del _make_gate_method

    # -- constructors from external formats -----------------------------------

    @classmethod
    def from_qsim_str(cls, contents, **circuit_opts):
        """Build from a qsim-format string (reference ``from_qsim_str``
        circuit/core.py:378)."""
        from .qasm import parse_qsim_str

        info = parse_qsim_str(contents)
        qc = cls(info["n"], **circuit_opts)
        qc.apply_gates(info["gates"])
        return qc

    @classmethod
    def from_qsim_file(cls, fname, **circuit_opts):
        with open(fname) as f:
            return cls.from_qsim_str(f.read(), **circuit_opts)

    @classmethod
    def from_openqasm2_str(cls, contents, **circuit_opts):
        from .qasm import parse_openqasm2_str

        info = parse_openqasm2_str(contents)
        qc = cls(info["n"], **circuit_opts)
        qc.apply_gates(info["gates"])
        return qc

    @classmethod
    def from_openqasm2_file(cls, fname, **circuit_opts):
        with open(fname) as f:
            return cls.from_openqasm2_str(f.read(), **circuit_opts)

    @classmethod
    def from_openqasm3_str(cls, contents, **circuit_opts):
        """Build from an OpenQASM 3 string; symbolic ``input``
        declarations become named circuit parameters bindable via
        :meth:`set_params` (reference circuit/core.py:438)."""
        from .qasm import parse_openqasm3_str

        info = parse_openqasm3_str(contents)
        qc = cls(info["n"], **circuit_opts)
        qc.apply_gates(info["gates"])
        if info.get("symbols") or info.get("expressions"):
            qc.register_named_params(
                {
                    name: (
                        float("nan") if isinstance(value, str) else value
                    )
                    for name, value in info["symbols"].items()
                },
                info["expressions"],
            )
        return qc

    @classmethod
    def from_qasm(cls, contents, **circuit_opts):
        """Alias of ``from_openqasm2_str`` (reference
        ``from_qasm``)."""
        return cls.from_openqasm2_str(contents, **circuit_opts)

    @classmethod
    def from_qasm_file(cls, fname, **circuit_opts):
        return cls.from_openqasm2_file(fname, **circuit_opts)

    @classmethod
    def _from_url(cls, url, parser, **circuit_opts):
        from urllib.request import urlopen

        with urlopen(url) as f:
            return parser(f.read().decode(), **circuit_opts)

    @classmethod
    def from_qasm_url(cls, url, **circuit_opts):
        return cls._from_url(url, cls.from_openqasm2_str,
                             **circuit_opts)

    @classmethod
    def from_openqasm2_url(cls, url, **circuit_opts):
        return cls._from_url(url, cls.from_openqasm2_str,
                             **circuit_opts)

    @classmethod
    def from_openqasm3_url(cls, url, **circuit_opts):
        return cls._from_url(url, cls.from_openqasm3_str,
                             **circuit_opts)

    @classmethod
    def from_qsim_url(cls, url, **circuit_opts):
        return cls._from_url(url, cls.from_qsim_str, **circuit_opts)

    @classmethod
    def from_openqasm3_file(cls, fname, **circuit_opts):
        with open(fname) as f:
            return cls.from_openqasm3_str(f.read(), **circuit_opts)


def _probabilities(data, B=None):
    """A contracted marginal's real part as float64 host probabilities,
    clipped at 0 (one row per sample when ``B`` is given)."""
    data = to_host(data)
    shape = (-1,) if B is None else (B, -1)
    return np.clip(
        np.real(np.reshape(data, shape)).astype(np.float64), 0, None,
    )


class Circuit(CircuitBase):
    """Exact lazy-TN circuit simulator (reference ``Circuit``
    exact.py:38). Gates are appended as host tensors; quantities are
    computed by lightcone selection + simplification on the host, then
    an optimized contraction on ``device``."""

    _host_gate_arrays = True

    def __init__(self, N=None, psi0=None, gate_opts=None, tags=None,
                 dtype=None, device=None, convert_eager=False):
        gate_opts = dict(gate_opts or {})
        gate_opts.setdefault("contract", "auto-split-gate")
        super().__init__(N=N, psi0=psi0, gate_opts=gate_opts, tags=tags,
                         dtype=dtype, device=device)
        # map qubit -> list of gate numbers that touched it
        self._qubit_gates = {q: [] for q in range(self.N)}
        self._sample_cache = LRU(2**16)
        self._marginal_cache = LRU(2**12)
        self._lightcone_cache = LRU(2**8)
        self._region_expr_cache = LRU(2**8)
        self._amp_expr = None

    def _init_state(self, psi0):
        psi = TensorNetwork(psi0, virtual=False)
        psi.view_like_(psi0)
        for i in range(psi0.L):
            psi[psi0.site_tag(i)].add_tag("PSI0")
        # host numpy leaves, like the gate tensors: the lazy network
        # stays on the host through the graph surgery (``isel_`` of fixed
        # outputs, simplification rewrites); only the final contraction
        # runs on the device. The numpy context keeps Tensor.modify from
        # moving the host arrays to the default device.
        dtype = numpy_dtype(self.dtype)
        with contract_backend("numpy"):
            psi.apply_to_arrays(
                lambda a: np.asarray(to_host(a), dtype=dtype)
            )
        return psi

    @property
    def psi(self):
        """The current state as a tensor network (copy)."""
        return self._psi.copy()

    def _apply_array(self, U, where, tags=None, contract=None, **opts):
        opts = {**self.gate_opts, **opts}
        if contract is not None:
            opts["contract"] = contract
        gnum = len(self.gates) - 1
        if len(where) == 1:
            opts["contract"] = True
        inds = tuple(self._psi.site_ind(q) for q in where)
        # host numpy throughout: applying one gate touches only tiny
        # tensors (the lazy network's leaves)
        with contract_backend("numpy"):
            tensor_network_gate_inds(
                self._psi, U, inds, tags=tags, inplace=True, **opts
            )
        for q in where:
            self._qubit_gates[q].append(gnum)

    def _contract(self, tn, backend=None, **contract_opts):
        """Contract the host network ``tn`` fully: on ``self.device``
        (its arrays moved there in one transfer), or on the host when
        ``backend == "numpy"``."""
        if backend == "numpy":
            with contract_backend("numpy"):
                return tn.contract(..., **contract_opts)
        _network_to_device(tn, self.device)
        return tn.contract(..., backend="torch", **contract_opts)

    # -- lightcones ---------------------------------------------------------

    def get_reverse_lightcone_tags(self, where):
        """Tags of gates in the reverse lightcone of qubits ``where``
        (reference exact.py:215)."""
        if isinstance(where, numbers.Integral):
            where = (where,)
        cone_qubits = set(where)
        cone_gates = []
        for gnum in range(len(self.gates) - 1, -1, -1):
            g = self.gates[gnum]
            gq = set(g.qubits) | set(g.controls)
            if gq & cone_qubits:
                cone_gates.append(gnum)
                cone_qubits |= gq
        return tuple(f"GATE_{g}" for g in reversed(cone_gates)), \
            cone_qubits

    def get_psi_reverse_lightcone(self, where, keep_psi0=False):
        """The sub network of the state affecting qubits ``where``
        (reference exact.py:271)."""
        if isinstance(where, numbers.Integral):
            where = (where,)
        tags, cone_qubits = self.get_reverse_lightcone_tags(where)
        psi = self._psi
        keep = oset(tags)
        keep.update(psi.site_tag(q) for q in cone_qubits)
        tn = psi.select(tuple(keep), which="any").copy()
        # non-cone initial-state tensors are norm-1 product tensors and
        # are excluded entirely (the reference's lightcone trick)
        tn.view_like_(psi)
        return tn

    # -- quantities -----------------------------------------------------------

    def amplitude(self, b, optimize="auto", simplify_sequence="ADCR",
                  simplify_atol=1e-12, rehearse=False, backend=None,
                  dtype=None, mesh=None):
        """The amplitude <b|psi> (reference ``amplitude`` exact.py:417),
        as a Python complex. The network is fixed to ``b`` and simplified
        on the host, then contracted on ``self.device`` (on the host with
        ``backend="numpy"``). With ``rehearse`` returns the simplified
        network and its contraction expression instead."""
        if mesh is not None:
            raise NotImplementedError(
                "Circuit.amplitude(mesh=...) is not ported to quimb_torch "
                "yet: ROADMAP item 18"
            )
        if isinstance(b, str):
            b = tuple(int(x) for x in b)
        self._maybe_init_storage()
        with contract_backend("numpy"):
            psi = self._psi.copy()
            for q in range(self.N):
                ind = psi.site_ind(q)
                psi.isel_({ind: int(b[q])})
            psi.full_simplify_(
                seq=simplify_sequence, atol=simplify_atol,
                output_inds=(),
            )
        if rehearse:
            return {
                "tn": psi,
                "tree": psi.contraction_info(optimize=optimize),
            }
        return complex(to_host(
            self._contract(psi, backend, optimize=optimize)).item())

    def amplitude_rehearse(self, b=None, **kwargs):
        if b is None:
            b = "0" * self.N
        return self.amplitude(b, rehearse=True, **kwargs)

    def partial_trace(self, keep, optimize="auto",
                      simplify_sequence="ADCR", simplify_atol=1e-12,
                      rehearse=False, **contract_opts):
        """Dense reduced density matrix of qubits ``keep``, a tensor on
        ``self.device`` (reference ``partial_trace`` exact.py:561)."""
        if isinstance(keep, numbers.Integral):
            keep = (keep,)
        psi = self.get_psi_reverse_lightcone(keep)
        kix = [psi.site_ind(q) for q in keep]
        bix = [rand_uuid() for _ in keep]
        with contract_backend("numpy"):
            bra = psi.H
            bra.reindex_(dict(zip(kix, bix)))
            bra.mangle_inner_()
            rho_tn = psi & bra
            rho_tn.full_simplify_(
                seq=simplify_sequence, atol=simplify_atol,
                output_inds=(*kix, *bix),
            )
        if rehearse:
            return {"tn": rho_tn}
        t = self._contract(
            rho_tn, contract_opts.pop("backend", None),
            output_inds=(*kix, *bix), optimize=optimize,
            preserve_tensor=True, **contract_opts,
        )
        d = 2 ** len(keep)
        return t.data.reshape(d, d)

    def local_expectation(self, G, where, optimize="auto",
                          simplify_sequence="ADCR", simplify_atol=1e-12,
                          rehearse=False, **contract_opts):
        """<psi|G|psi> for a local operator on qubits ``where``
        (reference ``local_expectation`` exact.py:659), as a Python
        complex."""
        if isinstance(where, numbers.Integral):
            where = (where,)
        rho = self.partial_trace(
            keep=where, optimize=optimize,
            simplify_sequence=simplify_sequence,
            simplify_atol=simplify_atol, **contract_opts,
        )
        d = rho.shape[0]
        if isinstance(rho, np.ndarray):
            G = np.asarray(to_host(G), dtype=rho.dtype).reshape(d, d)
            return complex(np.trace(G @ rho))
        G = to_device(G, device=rho.device, dtype=rho.dtype).reshape(d, d)
        return complex(torch.trace(G @ rho).item())

    def compute_marginal(self, where, fix=None, optimize="auto",
                         simplify_sequence="ADCRS", simplify_atol=1e-6,
                         equalize_norms=True, mesh=None,
                         **contract_opts):
        """Probability distribution p(where | fix) as a dense float64
        host array, normalized to sum to 1 (reference
        ``compute_marginal`` exact.py:780 returns the joint-scaled
        marginal; here the contraction is performed scale-free and the
        conditional normalization is restored on the host)."""
        if mesh is not None:
            raise NotImplementedError(
                "Circuit.compute_marginal(mesh=...) is not ported to "
                "quimb_torch yet: ROADMAP item 18"
            )
        fix = dict(fix or {})
        self._maybe_init_storage()
        key = (tuple(where), tuple(sorted(fix.items())))
        cached = self._marginal_cache.get(key)
        if cached is not None:
            return cached
        region = tuple(sorted(set(where) | set(fix)))

        if not contract_opts:
            # ONE cached contraction expression per (region, where,
            # fix-keys): the fixed bits enter as basis vectors, which the
            # path absorbs first (equivalent to isel), so the per-sample
            # work is one contraction with a cached path. Width-guarded:
            # oversized expressions take the per-sample simplify route.
            entry = self._get_region_marginal_expr(
                region, tuple(where), tuple(sorted(fix)),
                simplify_sequence, simplify_atol,
            )
            if entry is not None:
                expr, arrays, present, eye2 = entry
                vecs = [eye2[int(fix[q])] for q in present]
                p = _probabilities(expr(*arrays, *vecs))
                total = p.sum()
                if total > 0:
                    p = p / total
                self._marginal_cache[key] = p
                return p
        # the expensive lightcone + simplify is cached per *region*:
        # across samples only the fixed bit values change
        # (reference get_rdm_lightcone_simplified exact.py:356)
        nm_lc = self._get_norm_lightcone_simplified(
            region, simplify_sequence, simplify_atol
        )
        # diagonal trick: bra index = ket index contracts straight to
        # the probability diagonal p_i = rho_ii (reference exact.py:828)
        kix = tuple(self.ket_site_ind(q) for q in where)
        with contract_backend("numpy"):
            nm_lc.reindex_({
                self.bra_site_ind(q): self.ket_site_ind(q)
                for q in region
                if self.bra_site_ind(q) in nm_lc.ind_map
            })
            if fix:
                nm_lc.isel_({
                    self.ket_site_ind(q): int(v) for q, v in fix.items()
                    if self.ket_site_ind(q) in nm_lc.ind_map
                })
            nm_lc.full_simplify_(
                seq=_POST_FIX_SIMPLIFY or simplify_sequence,
                atol=simplify_atol,
                output_inds=kix, equalize_norms=equalize_norms,
            )
            # marginals are consumed normalized: the stripped global
            # exponent is dropped, the returned p is defined up to scale
            nm_lc.exponent = 0.0
        data = self._contract(
            nm_lc, contract_opts.pop("backend", None),
            output_inds=kix, optimize=optimize, preserve_tensor=True,
            renorm=True, **contract_opts,
        ).data
        p = _probabilities(data)
        total = p.sum()
        if total > 0:
            p = p / total
        self._marginal_cache[key] = p
        return p

    def _marginal_operands(self, region, seq, atol):
        """The norm network of ``region`` with bra = ket on the region,
        as scale-free complex128 host arrays and their (repeat-free)
        index terms: the operands of a cached marginal expression."""
        nm = self._get_norm_lightcone_simplified(region, seq, atol)
        with contract_backend("numpy"):
            nm.reindex_({
                self.bra_site_ind(q): self.ket_site_ind(q)
                for q in region
                if self.bra_site_ind(q) in nm.ind_map
            })
            # scale-free: mantissas O(1), the exponent is irrelevant as
            # the marginal is normalized
            nm.equalize_norms_(1.0)
        arrays, inputs = [], []
        for t in nm.tensor_map.values():
            a, term = _collapse_repeats(
                np.asarray(to_host(t.data)).astype(np.complex128),
                tuple(t.inds),
            )
            arrays.append(a)
            inputs.append(term)
        return nm, arrays, inputs

    def _get_region_marginal_expr(self, region, where, fixkeys, seq,
                                  atol):
        """Cached: (contract expression, its complex128 arrays on
        ``self.device``, fixed qubits present in the region lightcone,
        the basis vectors on the device) for computing the marginal of
        ``where`` given any values of ``fixkeys``."""
        key = (region, where, fixkeys, seq, atol)
        entry = self._region_expr_cache.get(key)
        if entry is not None:
            return None if entry == "fallback" else entry
        nm, arrays, inputs = self._marginal_operands(region, seq, atol)
        kix = tuple(self.ket_site_ind(q) for q in where)
        present = tuple(
            q for q in fixkeys
            if self.ket_site_ind(q) in nm.ind_map
        )
        inputs += [(self.ket_site_ind(q),) for q in present]
        expr = array_contract_expression(
            tuple(inputs), kix,
            shapes=[a.shape for a in arrays] + [(2,)] * len(present),
        )
        if expr.width > _EXPR_WIDTH_LIMIT or \
                expr.flops > _EXPR_FLOPS_LIMIT:
            # a value-specific re-simplify will beat any path here
            self._region_expr_cache[key] = "fallback"
            return None
        *arrays, eye2 = _arrays_to_device(
            [*arrays, np.eye(2, dtype=np.complex128)], self.device
        )
        entry = (expr, arrays, present, eye2)
        self._region_expr_cache[key] = entry
        return entry

    def _get_norm_lightcone_simplified(self, region, seq, atol):
        """Cached: the lightcone norm network <psi|psi> with the ket
        AND bra indices of ``region`` left open, fully simplified on the
        host. Returns a fresh copy each call."""
        key = (region, seq, atol)
        cached = self._lightcone_cache.get(key)
        if cached is None:
            psi = self.get_psi_reverse_lightcone(region)
            with contract_backend("numpy"):
                bra = psi.H
                kix = [self.ket_site_ind(q) for q in region]
                bix = [self.bra_site_ind(q) for q in region]
                bra.reindex_(dict(zip(kix, bix)))
                bra.mangle_inner_()
                tn = psi & bra
                tn.full_simplify_(
                    seq=seq, atol=atol, output_inds=(*kix, *bix),
                )
            self._lightcone_cache[key] = cached = tn
        return cached.copy()

    def calc_qubit_ordering(self, qubits=None, method="greedy-lightcone"):
        """Order qubits by increasing reverse-lightcone size
        (reference exact.py:918)."""
        if qubits is None:
            qubits = range(self.N)
        sizes = {}
        for q in qubits:
            _, cone = self.get_reverse_lightcone_tags((q,))
            sizes[q] = len(cone)
        return tuple(sorted(sizes, key=sizes.get))

    def sample(self, C, qubits=None, order=None, group_size=10,
               seed=None, optimize="auto", simplify_sequence="ADCRS",
               simplify_atol=1e-6, mesh=None, **contract_opts):
        """Generate ``C`` samples via chain-rule marginals with caching
        (reference ``sample`` exact.py:1135)."""
        if mesh is not None:
            raise NotImplementedError(
                "Circuit.sample(mesh=...) is not ported to quimb_torch "
                "yet: ROADMAP item 18"
            )
        rng = np.random.default_rng(seed)
        if qubits is None:
            qubits = tuple(range(self.N))
        if order is None:
            order = self.calc_qubit_ordering(qubits)
        groups = [
            order[i:i + group_size]
            for i in range(0, len(order), group_size)
        ]
        if C > 1 and not contract_opts:
            # breadth-first: advance ALL samples one group at a time —
            # the C distinct-fix marginals of a group share one cached
            # contraction expression with the batch riding as an extra
            # index on the bit vectors
            yield from self._sample_breadth_first(
                C, groups, rng, optimize, simplify_sequence,
                simplify_atol,
            )
            return
        for _ in range(C):
            fix = {}
            for grp in groups:
                p = self.compute_marginal(
                    grp, fix=fix, optimize=optimize,
                    simplify_sequence=simplify_sequence,
                    simplify_atol=simplify_atol, **contract_opts,
                )
                p = p / p.sum()
                outcome = rng.choice(p.size, p=p)
                bits = [(outcome >> (len(grp) - 1 - i)) & 1
                        for i in range(len(grp))]
                for q, v in zip(grp, bits):
                    fix[q] = v
            yield "".join(str(fix[q]) for q in range(self.N)
                          if q in fix)

    def _sample_breadth_first(self, C, groups, rng, optimize, seq,
                              atol):
        fixes = [dict() for _ in range(C)]
        for grp in groups:
            fixkeys = tuple(sorted(fixes[0]))
            region = tuple(sorted(set(grp) | set(fixkeys)))
            entry = self._get_region_marginal_batch_expr(
                region, tuple(grp), fixkeys, seq, atol, C,
            )
            if entry is None:
                # oversized: per-sample route for this group
                ps = [
                    self.compute_marginal(
                        grp, fix=fixes[i], optimize=optimize,
                        simplify_sequence=seq, simplify_atol=atol,
                    )
                    for i in range(C)
                ]
            else:
                expr, arrays, present, B = entry
                # the bit vectors of every sample, padded to B with |0>,
                # built on the host and moved in one transfer
                bits = np.zeros((len(present), B), dtype=np.int64)
                for k, q in enumerate(present):
                    for i in range(C):
                        bits[k, i] = int(fixes[i][q])
                V = np.eye(2, dtype=np.complex128)[bits]
                (V,) = _arrays_to_device([V], self.device)
                P = _probabilities(expr(*arrays, *V), B)
                ps = [P[i] for i in range(C)]
            for i in range(C):
                p = ps[i]
                total = p.sum()
                p = p / total if total > 0 else np.full(
                    p.size, 1.0 / p.size
                )
                outcome = rng.choice(p.size, p=p)
                bits = [(outcome >> (len(grp) - 1 - k)) & 1
                        for k in range(len(grp))]
                for q, v in zip(grp, bits):
                    fixes[i][q] = v
        for i in range(C):
            yield "".join(
                str(fixes[i][q]) for q in range(self.N)
                if q in fixes[i]
            )

    def _get_region_marginal_batch_expr(self, region, where, fixkeys,
                                        seq, atol, C):
        """Cached batched variant of :meth:`_get_region_marginal_expr`:
        the fixed-bit vectors carry a shared batch index (padded to a
        power of two >= C so different sample counts reuse one
        path/expression). Its arrays lie on ``self.device``."""
        B = 1
        while B < C:
            B *= 2
        key = ("batch", region, where, fixkeys, seq, atol, B)
        entry = self._region_expr_cache.get(key)
        if entry is not None:
            return None if entry == "fallback" else entry
        nm, arrays, inputs = self._marginal_operands(region, seq, atol)
        kix = tuple(self.ket_site_ind(q) for q in where)
        present = tuple(
            q for q in fixkeys
            if self.ket_site_ind(q) in nm.ind_map
        )
        if not present:
            # no batch coupling (first group: the plain per-sample cache
            # computes it exactly once)
            self._region_expr_cache[key] = "fallback"
            return None
        bix = rand_uuid()
        inputs += [(bix, self.ket_site_ind(q)) for q in present]
        shapes = [a.shape for a in arrays] + [(B, 2)] * len(present)
        # cheap plain-greedy probe first: the full multi-restart path
        # search on a big network that is then discarded (oversized)
        # would dominate the cold sampling setup
        probe = array_contract_expression(
            tuple(inputs), (bix,) + kix, shapes=shapes,
            optimize="greedy",
        )
        if probe.width > _EXPR_WIDTH_LIMIT + math.log2(B) or \
                probe.flops > B * _EXPR_FLOPS_LIMIT:
            self._region_expr_cache[key] = "fallback"
            return None
        expr = array_contract_expression(
            tuple(inputs), (bix,) + kix, shapes=shapes,
        )
        if expr.flops > probe.flops:
            expr = probe
        entry = (expr, _arrays_to_device(arrays, self.device), present, B)
        self._region_expr_cache[key] = entry
        return entry

    def sample_chaotic(self, C, marginal_qubits, seed=None, **kwargs):
        """Sample assuming chaotic (near-uniform) marginals on all but
        ``marginal_qubits`` (reference ``sample_chaotic``
        exact.py:1374)."""
        rng = np.random.default_rng(seed)
        if isinstance(marginal_qubits, numbers.Integral):
            order = self.calc_qubit_ordering()
            marginal_qubits = order[:marginal_qubits]
        marginal_qubits = tuple(marginal_qubits)
        rest = [q for q in range(self.N) if q not in marginal_qubits]
        for _ in range(C):
            fix = {q: int(rng.integers(2)) for q in rest}
            p = self.compute_marginal(marginal_qubits, fix=fix, **kwargs)
            p = p / p.sum()
            outcome = rng.choice(p.size, p=p)
            bits = [(outcome >> (len(marginal_qubits) - 1 - i)) & 1
                    for i in range(len(marginal_qubits))]
            for q, v in zip(marginal_qubits, bits):
                fix[q] = v
            yield "".join(str(fix[q]) for q in range(self.N))

    def get_gate_by_gate_circuits(self, group_size=10):
        """Partition the gates into a growing sequence of prefix
        circuits, each acting on at most ``group_size`` new qubits
        compared to its predecessor (reference
        ``get_gate_by_gate_circuits`` exact.py:1589)."""
        circs = [self.__class__(self.N, dtype=self.dtype,
                                device=self.device)]
        groups = []
        current_group = set()
        for gate in self.gates:
            qs = set(gate.qubits) | set(gate.controls)
            next_group = current_group | qs
            if len(next_group) > group_size and current_group:
                groups.append(tuple(sorted(current_group)))
                circs.append(circs[-1].copy())
                current_group = qs
            else:
                current_group = next_group
            circs[-1]._apply_gate(gate)
        groups.append(tuple(sorted(current_group)))
        return tuple(
            {"circuit": c, "where": g}
            for c, g in zip(circs, groups)
        )

    def sample_gate_by_gate(self, C, group_size=10, seed=None,
                            optimize="auto",
                            simplify_sequence="ADCRS",
                            simplify_atol=1e-6, **contract_opts):
        """Sample via the gate-by-gate (Markov) method of Bravyi,
        Gosset & Liu arXiv:2112.08499: evolve a bitstring through a
        growing sequence of prefix circuits, resampling only the
        qubits each new gate group acts on (reference
        ``sample_gate_by_gate`` exact.py:1635)."""
        rng = np.random.default_rng(seed)
        key = ("gate_by_gate_circuits", group_size)
        if not hasattr(self, "_gbg_storage"):
            self._gbg_storage = {}
        circs_wheres = self._gbg_storage.get(key)
        if circs_wheres is None:
            circs_wheres = self.get_gate_by_gate_circuits(group_size)
            self._gbg_storage[key] = circs_wheres

        for _ in range(C):
            result = {q: 0 for q in range(self.N)}
            for cw in circs_wheres:
                circ_g = cw["circuit"]
                where = cw["where"]
                if not where:
                    continue
                fix = {q: v for q, v in result.items()
                       if q not in where}
                p = circ_g.compute_marginal(
                    where, fix=fix, optimize=optimize,
                    simplify_sequence=simplify_sequence,
                    simplify_atol=simplify_atol, **contract_opts,
                )
                p = p / p.sum()
                outcome = rng.choice(p.size, p=p)
                bits = [(outcome >> (len(where) - 1 - i)) & 1
                        for i in range(len(where))]
                for q, v in zip(where, bits):
                    result[q] = v
            yield "".join(str(result[q]) for q in range(self.N))

    def to_dense(self, optimize="auto", simplify_sequence="R",
                 simplify_atol=1e-12, **contract_opts):
        """Full dense statevector, a ``(2**N, 1)`` tensor on
        ``self.device`` (reference ``to_dense`` exact.py:1851)."""
        psi = self._psi.copy()
        output_inds = tuple(psi.site_ind(q) for q in range(self.N))
        with contract_backend("numpy"):
            psi.full_simplify_(
                seq=simplify_sequence, atol=simplify_atol,
                output_inds=output_inds,
            )
        t = self._contract(
            psi, contract_opts.pop("backend", None),
            output_inds=output_inds, optimize=optimize,
            preserve_tensor=True, **contract_opts,
        )
        return t.data.reshape(-1, 1)

    def simulate_counts(self, C, seed=None, **kwargs):
        """Sample C measurements into a counts dict."""
        counts = {}
        for b in self.sample(C, seed=seed, **kwargs):
            counts[b] = counts.get(b, 0) + 1
        return counts

    def xeb(self, samples, **kwargs):
        """Linear cross-entropy benchmark from bitstring samples."""
        d = 2**self.N
        total = 0.0
        n = 0
        for b in samples:
            p = abs(complex(self.amplitude(b, **kwargs))) ** 2
            total += p
            n += 1
        return d * total / n - 1

    def xeb_ex(self, optimize="auto", **kwargs):
        """Exact expected XEB = d * sum_b p(b)^2 - 1 (reference
        ``xeb_ex`` exact.py:1944), via the dense state for moderate N."""
        psi = to_host(self.to_dense(optimize=optimize, **kwargs))
        p = np.abs(psi.reshape(-1)) ** 2
        return float(2**self.N * np.sum(p**2) - 1)

    # -- introspection -----------------------------------------------------

    def amplitude_tn(self, b=None):
        if b is None:
            b = "0" * self.N
        return self.amplitude(b, rehearse=True)["tn"]

    def __repr__(self):
        return (
            f"<{self.__class__.__name__}(n={self.N}, "
            f"num_gates={self.num_gates})>"
        )


class CircuitDense(CircuitBase):
    """Dense statevector simulator (reference ``CircuitDense``
    exact.py:2026): not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "CircuitDense is not ported to quimb_torch yet: ROADMAP item 16"
        )


# ---------------------------------------------------------------------------
# Circuit parity extras (reference exact.py:207-1943)
# ---------------------------------------------------------------------------

def _circ_get_psi(self):
    """The current wavefunction TN, squeezed (reference ``get_psi``
    exact.py:161)."""
    psi = self._psi.copy()
    with contract_backend("numpy"):
        psi.squeeze_()
    return psi


def _circ_get_uni(self, transposed=False):
    """The circuit as a unitary TN on ``self.device``, rebuilt from the
    recorded gates (input indices ``b{q}``, output indices ``k{q}``;
    reference ``get_uni`` exact.py:171)."""
    U = TensorNetwork([])
    cur = {q: self.bra_site_ind(q) for q in range(self.N)}
    for gnum, g in enumerate(self._gates):
        qs = (*g.controls, *g.qubits)
        nq = len(qs)
        arr = to_device(g.build_array(), device=self.device,
                        dtype=self.dtype)
        new = {q: rand_uuid() for q in qs}
        inds = [new[q] for q in qs] + [cur[q] for q in qs]
        tags = (f"GATE_{gnum}",) + (
            (g.label,) if isinstance(g.label, str) else ()
        )
        U.add_tensor(Tensor(arr.reshape((2,) * (2 * nq)), inds=inds,
                            tags=tags))
        cur.update(new)
    for q in range(self.N):
        if cur[q] == self.bra_site_ind(q):
            # untouched qubit: identity wire
            U.add_tensor(Tensor(
                torch.eye(2, dtype=self.dtype, device=self.device),
                inds=(f"k{q}", self.bra_site_ind(q)),
                tags=(f"I{q}",),
            ))
        else:
            U.reindex_({cur[q]: f"k{q}"})
    if transposed:
        remap = {}
        for q in range(self.N):
            remap[f"k{q}"] = self.bra_site_ind(q)
            remap[self.bra_site_ind(q)] = f"k{q}"
        U.reindex_(remap)
    return U


def _circ_uni(self):
    return self.get_uni()


def _circ_get_psi_simplified(self, seq="ADCRS", atol=1e-12,
                             equalize_norms=False):
    """The wavefunction TN post local simplification, host arrays
    (reference ``get_psi_simplified`` exact.py:310)."""
    psi = self._psi.copy()
    out = tuple(psi.site_ind(q) for q in range(self.N))
    psi.full_simplify_(seq=seq, atol=atol, output_inds=out)
    return psi


def _circ_get_rdm_lightcone_simplified(self, where, seq="ADCRS",
                                       atol=1e-12,
                                       equalize_norms=False):
    """The (uncontracted) simplified density-matrix lightcone TN of
    ``where`` (reference ``get_rdm_lightcone_simplified``
    exact.py:356)."""
    return self.partial_trace(
        where, simplify_sequence=seq, simplify_atol=atol,
        rehearse=True,
    )["tn"]


def _circ_get_qubit_distances(self, method=None, alpha=2):
    """Nested dict of qubit graph distances — edge between qubits
    sharing a gate (reference ``get_qubit_distances``
    exact.py:998)."""
    adj = {q: set() for q in range(self.N)}
    for g in self._gates:
        qs = (*g.qubits, *g.controls)
        for a in qs:
            for b in qs:
                if a != b:
                    adj[a].add(b)
    out = {}
    for src in range(self.N):
        dist = {src: 0}
        frontier = [src]
        while frontier:
            new = []
            for a in frontier:
                for b in adj[a]:
                    if b not in dist:
                        dist[b] = dist[a] + 1
                        new.append(b)
            frontier = new
        out[src] = dist
    return out


def _circ_reordered_gates_dfs_clustered(self):
    """Gates reordered by a DFS over the multi-qubit-gate graph,
    single-qubit gates placed adjacent to their multi-qubit successors
    (reference ``reordered_gates_dfs_clustered`` exact.py:1041)."""
    gates = self._gates
    pending = {q: [] for q in range(self.N)}
    multi = []
    for i, g in enumerate(gates):
        qs = (*g.qubits, *g.controls)
        if len(qs) == 1:
            pending[qs[0]].append(i)
        else:
            multi.append(i)
    out = []
    seen = set()

    def emit(i):
        g = gates[i]
        for q in (*g.qubits, *g.controls):
            for j in pending[q]:
                if j not in seen and j < i:
                    seen.add(j)
                    out.append(gates[j])
        seen.add(i)
        out.append(g)

    for i in multi:
        emit(i)
    for i, g in enumerate(gates):
        if i not in seen:
            out.append(g)
            seen.add(i)
    return tuple(out)


def _circ_schrodinger_contract(self, *args, **contract_opts):
    """Contract the state TN in gate-application order on
    ``self.device`` (reference ``schrodinger_contract``
    exact.py:1939): each tensor in turn into the running result, a path
    in the single-static-assignment form the contraction takes."""
    ntensor = self._psi.num_tensors
    path = [(0, 1)] + [(i, ntensor + i - 2) for i in range(2, ntensor)]
    psi = _network_to_device(self.psi, self.device)
    return psi.contract(*args, optimize=path, **contract_opts)


def _circ_to_dense_tn(self, simplify_sequence="R",
                      simplify_atol=1e-12, **kwargs):
    """The (simplified) TN whose contraction gives the dense state
    (reference ``to_dense_tn``)."""
    psi = self._psi.copy()
    out = tuple(psi.site_ind(q) for q in range(self.N))
    psi.full_simplify_(seq=simplify_sequence, atol=simplify_atol,
                       output_inds=out)
    return psi


def _circ_to_dense_rehearse(self, **kwargs):
    tn = _circ_to_dense_tn(self, **kwargs)
    return {"tn": tn, "tree": tn.contraction_info()}


def _circ_partial_trace_tn(self, keep, **kwargs):
    return self.partial_trace(keep, rehearse=True, **kwargs)["tn"]


def _circ_partial_trace_rehearse(self, keep, **kwargs):
    tn = _circ_partial_trace_tn(self, keep, **kwargs)
    return {"tn": tn, "tree": tn.contraction_info()}


def _circ_local_expectation_tn(self, G, where, **kwargs):
    """The TN of ``<psi|G|psi>`` uncontracted (reference
    ``local_expectation_tn``)."""
    return _circ_partial_trace_tn(self, where, **kwargs)


def _circ_local_expectation_rehearse(self, G, where, **kwargs):
    tn = _circ_local_expectation_tn(self, G, where, **kwargs)
    return {"tn": tn, "tree": tn.contraction_info()}


def _circ_compute_marginal_tn(self, where, fix=None, **kwargs):
    """The lightcone TN for a marginal computation (reference
    ``compute_marginal_tn``)."""
    fix = dict(fix or {})
    cone_qubits = tuple(where) + tuple(fix)
    psi = self.get_psi_reverse_lightcone(cone_qubits)
    with contract_backend("numpy"):
        bra = psi.H
        sel = {
            psi.site_ind(q): int(v) for q, v in fix.items()
            if psi.site_ind(q) in psi.ind_map
        }
        psi.isel_(sel)
        bra.isel_(sel)
        kix = [psi.site_ind(q) for q in where]
        bix = [rand_uuid() for _ in where]
        bra.reindex_(dict(zip(kix, bix)))
        bra.mangle_inner_()
    return psi & bra


def _circ_compute_marginal_rehearse(self, where, fix=None, **kwargs):
    tn = _circ_compute_marginal_tn(self, where, fix=fix, **kwargs)
    return {"tn": tn, "tree": tn.contraction_info()}


def _circ_sample_tns(self, qubits=None, order=None, group_size=10,
                     **kwargs):
    """The marginal TNs a ``sample`` call would contract, one per
    qubit group (reference ``sample_tns``)."""
    if qubits is None:
        qubits = tuple(range(self.N))
    if order is None:
        order = self.calc_qubit_ordering(qubits)
    groups = [
        tuple(order[i:i + group_size])
        for i in range(0, len(order), group_size)
    ]
    return [
        _circ_compute_marginal_tn(self, grp, fix={}) for grp in groups
    ]


def _circ_sample_rehearse(self, qubits=None, order=None,
                          group_size=10, result=None, **kwargs):
    tns = _circ_sample_tns(self, qubits=qubits, order=order,
                           group_size=group_size)
    return {
        i: {"tn": tn, "tree": tn.contraction_info()}
        for i, tn in enumerate(tns)
    }


def _circ_sample_chaotic_tn(self, marginal_qubits, **kwargs):
    """The single marginal TN of a chaotic sample (reference
    ``sample_chaotic_tn``)."""
    if isinstance(marginal_qubits, numbers.Integral):
        order = self.calc_qubit_ordering()
        marginal_qubits = order[:marginal_qubits]
    return _circ_compute_marginal_tn(self, tuple(marginal_qubits))


def _circ_sample_chaotic_rehearse(self, marginal_qubits, **kwargs):
    tn = _circ_sample_chaotic_tn(self, marginal_qubits, **kwargs)
    return {"tn": tn, "tree": tn.contraction_info()}


def _circ_sample_gate_by_gate_tns(self, group_size=10, **kwargs):
    """The circuit TNs of the gate-by-gate sampling scheme (reference
    ``sample_gate_by_gate_tns``)."""
    return [
        c["circuit"]._psi.copy()
        for c in self.get_gate_by_gate_circuits(group_size=group_size)
    ]


def _circ_sample_gate_by_gate_rehearse(self, group_size=10, **kwargs):
    tns = _circ_sample_gate_by_gate_tns(self, group_size=group_size)
    return {i: {"tn": tn} for i, tn in enumerate(tns)}


Circuit.get_psi = _circ_get_psi
Circuit.get_uni = _circ_get_uni
Circuit.uni = property(_circ_uni)
Circuit.get_psi_simplified = _circ_get_psi_simplified
Circuit.get_rdm_lightcone_simplified = _circ_get_rdm_lightcone_simplified
Circuit.get_qubit_distances = _circ_get_qubit_distances
Circuit.reordered_gates_dfs_clustered = _circ_reordered_gates_dfs_clustered
Circuit.schrodinger_contract = _circ_schrodinger_contract
Circuit.to_dense_tn = _circ_to_dense_tn
Circuit.to_dense_rehearse = _circ_to_dense_rehearse
Circuit.partial_trace_tn = _circ_partial_trace_tn
Circuit.partial_trace_rehearse = _circ_partial_trace_rehearse
Circuit.local_expectation_tn = _circ_local_expectation_tn
Circuit.local_expectation_rehearse = _circ_local_expectation_rehearse
Circuit.compute_marginal_tn = _circ_compute_marginal_tn
Circuit.compute_marginal_rehearse = _circ_compute_marginal_rehearse
Circuit.sample_tns = _circ_sample_tns
Circuit.sample_rehearse = _circ_sample_rehearse
Circuit.sample_chaotic_tn = _circ_sample_chaotic_tn
Circuit.sample_chaotic_rehearse = _circ_sample_chaotic_rehearse
Circuit.sample_gate_by_gate_tns = _circ_sample_gate_by_gate_tns
Circuit.sample_gate_by_gate_rehearse = _circ_sample_gate_by_gate_rehearse
