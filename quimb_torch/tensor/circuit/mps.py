"""MPS circuit simulators.

Port of quimb_tpu's ``tensor/circuit/mps.py`` (reference
``quimb/tensor/circuit/mps.py``: ``CircuitMPS`` :26, ``CircuitPermMPS``
:569, ``CircuitMPSLazy`` :733). The state is a
:class:`~..tn1d.core.MatrixProductState` on the circuit's device, the GPU
unless the caller names another; each gate is applied to it at once, a
one-qubit gate contracted into its site, a two-qubit gate by reduce-split
with the circuit's truncation (swapped next to each other first where
the qubits are apart), a larger gate by contracting the gathered sites
into one blob and splitting it back. Sampling is the exact sequential MPS
sampler, drawing from ``np.random.default_rng(seed)`` on the host.
"""

import numbers

import numpy as np
import torch

from ...ops.backend import to_device, to_host
from ..core import Tensor, TensorNetwork, rand_uuid, tensor_contract
from ..tn1d.core import MatrixProductState, _swap_gate, expec_TN_1D
from .core import CircuitBase


def _reversed_pair(U):
    """The two-qubit gate ``U`` with its qubits' order swapped."""
    return U.reshape(2, 2, 2, 2).permute(1, 0, 3, 2).reshape(4, 4)


class CircuitMPS(CircuitBase):
    """A circuit simulated as an MPS of bounded bond dimension (reference
    ``CircuitMPS`` mps.py:26): ``max_bond`` and ``cutoff`` truncate each
    two-qubit gate's split."""

    def __init__(self, N=None, psi0=None, gate_opts=None, max_bond=None,
                 cutoff=1e-10, tags=None, dtype=None, device=None):
        gate_opts = dict(gate_opts or {})
        gate_opts.setdefault("max_bond", max_bond)
        gate_opts.setdefault("cutoff", cutoff)
        super().__init__(N=N, psi0=psi0, gate_opts=gate_opts, tags=tags,
                         dtype=dtype, device=device)

    def _init_state(self, psi0):
        psi = (psi0 if isinstance(psi0, MatrixProductState)
               else MatrixProductState(psi0))
        psi.apply_to_arrays(lambda a: to_device(a, device=self.device))
        return psi

    def _apply_array(self, U, where, tags=None, **opts):
        opts = {**self.gate_opts, **opts}
        opts.pop("contract", None)
        if len(where) == 1:
            self._psi.gate_(U, where[0], contract=True)
        elif len(where) == 2:
            i, j = where
            if i > j:
                U, i, j = _reversed_pair(U), j, i
            if j - i == 1:
                self._psi.gate_split_(U, (i, j), **opts)
            else:
                self._psi.gate_with_auto_swap_(U, (i, j), **opts)
        else:
            self._apply_nq(U, where, **opts)

    def _apply_nq(self, U, where, **opts):
        """An n-qubit (n >= 3) gate: swap its sites next to each other,
        contract the gate with their blob, split it back by successive
        SVDs, swap back."""
        psi = self._psi
        k = len(where)
        SWAP = _swap_gate(2, psi.dtype, self.device)
        swaps = []
        # site_of[q]: the site that holds qubit q now
        site_of = list(range(self.N))

        def occupied():
            return sorted(site_of[q] for q in where)

        # pack the gate's qubits next to the first of them, each moved
        # left past the other qubits only (quimb_tpu moves the right-most
        # one step at a time and can swap two of the gate's qubits back
        # and forth forever)
        first = occupied()[0]
        for n, s in enumerate(occupied()):
            while s > first + n:
                psi.gate_split_(SWAP, (s - 1, s), **opts)
                qa, qb = site_of.index(s - 1), site_of.index(s)
                site_of[qa], site_of[qb] = s, s - 1
                swaps.append(s - 1)
                s -= 1

        sites = occupied()
        inds = [psi.site_ind(site_of[q]) for q in where]
        new_inds = {ix: rand_uuid() for ix in inds}
        ts = [psi[psi.site_tag(s)] for s in sites]
        for t in ts:
            t.reindex_({ix: new_inds[ix] for ix in inds if ix in t.inds})
        TG = Tensor(to_device(U, device=self.device,
                              dtype=psi.dtype).reshape((2,) * (2 * k)),
                    inds=(*inds, *[new_inds[ix] for ix in inds]))
        blob = tensor_contract(*ts, TG, preserve_tensor=True)
        split_opts = {k_: v for k_, v in opts.items()
                      if k_ in ("max_bond", "cutoff", "cutoff_mode")}
        left_bond = []
        if sites[0] > 0:
            left_bond = [ix for ix in psi[psi.site_tag(sites[0] - 1)].inds
                         if ix in blob.inds]
        rem = blob
        for s in sites[:-1]:
            tl, tr = rem.split(left_inds=[*left_bond, psi.site_ind(s)],
                               get="tensors", absorb="right", **split_opts)
            tl.modify(tags=psi[psi.site_tag(s)].tags)
            psi[psi.site_tag(s)] = tl
            left_bond = [ix for ix in tr.inds if ix in tl.inds]
            rem = tr
        rem.modify(tags=psi[psi.site_tag(sites[-1])].tags)
        psi[psi.site_tag(sites[-1])] = rem
        for a in reversed(swaps):
            psi.gate_split_(SWAP, (a, a + 1), **opts)

    @property
    def psi(self):
        return self._psi.copy()

    def amplitude(self, b, **kwargs):
        """The amplitude <b|psi>, a Python complex."""
        if isinstance(b, str):
            b = tuple(int(x) for x in b)
        return complex(self._psi.amplitude(b))

    def to_dense(self, **kwargs):
        return self._psi.to_dense()

    def sample(self, C, seed=None, **kwargs):
        for config, _ in self._psi.sample(C, seed=seed):
            yield "".join(map(str, config))

    def local_expectation(self, G, where, **kwargs):
        if isinstance(where, numbers.Integral):
            where = (where,)
        psi = self._psi
        ket = psi.gate(G, tuple(where),
                       contract=True if len(where) == 1 else "split")
        return expec_TN_1D(psi.H, ket)

    def partial_trace(self, keep, **kwargs):
        if isinstance(keep, numbers.Integral):
            keep = (keep,)
        return self._psi.partial_trace(keep)

    def fidelity_estimate(self):
        """The squared norm of the state, which each truncation lowers
        from 1: an estimate of |<psi_ideal|psi>|^2 (reference
        mps.py:468)."""
        return float(torch.real(self._psi.norm())) ** 2

    def error_estimate(self):
        """``1 - fidelity_estimate()`` (reference mps.py:491)."""
        return 1 - self.fidelity_estimate()

    def compute_marginal(self, where, fix=None, **kwargs):
        """The distribution of qubits ``where`` given the fixed bits
        ``fix`` (reference ``compute_marginal`` mps.py:243), as float64
        host probabilities."""
        psi = self._psi.copy()
        for q, v in dict(fix or {}).items():
            psi.isel_({psi.site_ind(q): int(v)})
        rho = psi.partial_trace(tuple(where))
        p = to_host(torch.real(torch.diagonal(rho))).astype(np.float64)
        return np.clip(p, 0, None)

    def sample_chaotic(self, C, marginal_qubits, fix=None, seed=None,
                       **kwargs):
        """``marginal_qubits`` sampled exactly, the rest uniformly, as is
        valid deep in the chaotic regime (reference ``sample_chaotic``
        mps.py:323)."""
        rng = np.random.default_rng(seed)
        if isinstance(marginal_qubits, numbers.Integral):
            marginal_qubits = tuple(range(marginal_qubits))
        marginal_qubits = tuple(marginal_qubits)
        p = self.compute_marginal(marginal_qubits, fix=fix)
        p = p / p.sum()
        rest = [q for q in range(self.N) if q not in marginal_qubits]
        for _ in range(C):
            out = ["0"] * self.N
            bits = np.binary_repr(rng.choice(p.size, p=p),
                                  len(marginal_qubits))
            for q, b in zip(marginal_qubits, bits):
                out[q] = b
            for q in rest:
                out[q] = str(rng.integers(2))
            yield "".join(out)

    @property
    def uni(self):
        raise NotImplementedError("CircuitMPS contracts the state as it "
                                  "goes: the unitary network is not kept")

    def schrodinger_contract(self, *args, **kwargs):
        """The MPS is the Schrödinger-contracted state: its dense form."""
        return self.to_dense(**kwargs)


class CircuitPermMPS(CircuitMPS):
    """An MPS circuit simulator that permutes qubits lazily: a long-range
    gate swaps the qubits' positions and leaves them there (reference
    ``CircuitPermMPS`` mps.py:569)."""

    def __init__(self, N=None, psi0=None, **kwargs):
        super().__init__(N=N, psi0=psi0, **kwargs)
        self.qubit_perm = list(range(self.N))

    def _apply_array(self, U, where, tags=None, **opts):
        opts = {**self.gate_opts, **opts}
        opts.pop("contract", None)
        phys = [self.qubit_perm.index(q) for q in where]
        if len(phys) == 1:
            self._psi.gate_(U, phys[0], contract=True)
            return
        if len(phys) > 2:
            # at the physical positions; its swaps are undone, so the
            # permutation stays
            self._apply_nq(U, tuple(phys), **opts)
            return
        i, j = phys
        if i > j:
            U, i, j = _reversed_pair(U), j, i
        SWAP = _swap_gate(2, self._psi.dtype, self.device)
        while j > i + 1:
            self._psi.gate_split_(SWAP, (j - 1, j), **opts)
            self.qubit_perm[j - 1], self.qubit_perm[j] = \
                self.qubit_perm[j], self.qubit_perm[j - 1]
            j -= 1
        self._psi.gate_split_(U, (i, j), **opts)

    def get_psi_unpermuted(self):
        """The state with its physical sites relabelled in logical order."""
        psi = self._psi.copy()
        psi.reindex_({psi.site_ind(p): f"__logical{q}__"
                      for p, q in enumerate(self.qubit_perm)})
        psi.reindex_({f"__logical{q}__": psi._site_ind_id.format(q)
                      for q in range(self.N)})
        return psi

    get_psi = get_psi_unpermuted

    def get_psi_unordered(self):
        return self._psi.copy()

    def amplitude(self, b, **kwargs):
        if isinstance(b, str):
            b = tuple(int(x) for x in b)
        bp = tuple(b[self.qubit_perm[p]] for p in range(self.N))
        return complex(self._psi.amplitude(bp))

    def to_dense(self, **kwargs):
        psi = self.get_psi_unpermuted()
        inds = tuple(psi._site_ind_id.format(q) for q in range(self.N))
        t = psi.contract(..., output_inds=inds, preserve_tensor=True)
        return t.data.reshape(-1, 1)

    def sample(self, C, seed=None, **kwargs):
        for config, _ in self._psi.sample(C, seed=seed):
            logical = [0] * self.N
            for p, v in enumerate(config):
                logical[self.qubit_perm[p]] = v
            yield "".join(map(str, logical))


class CircuitMPSLazy(CircuitMPS):
    """An MPS circuit simulator that defers gates: neighbouring gates
    queue as tensors of a 1D network, and every ``flush_every`` of them
    the network is compressed back to an MPS by ``compress_method``
    (reference ``CircuitMPSLazy`` mps.py:733). A long-range gate flushes
    the queue and is applied by swaps."""

    def __init__(self, N=None, psi0=None, flush_every=8,
                 compress_method="zipup-oversample", **kwargs):
        super().__init__(N=N, psi0=psi0, **kwargs)
        self.flush_every = flush_every
        self.compress_method = compress_method
        self._queue = []

    def _apply_array(self, U, where, tags=None, **opts):
        nq = len(where)
        if nq == 1 or (nq == 2 and abs(where[0] - where[1]) == 1):
            self._queue.append((U, tuple(where)))
            if len(self._queue) >= self.flush_every:
                self.flush()
        else:
            self.flush()
            super()._apply_array(U, where, tags=tags, **opts)

    def flush(self):
        """Add the queued gates to the state lazily, then compress it back
        to an MPS."""
        if not self._queue:
            return
        from ..gating import gate_split_gate
        from ..tn1d.compress import tensor_network_1d_compress

        psi = self._psi
        tn = TensorNetwork(psi.copy(), virtual=True, check_collisions=False)
        tn.view_like_(psi)

        def add_gate(G, q, extra=()):
            ix = psi.site_ind(q)
            new = rand_uuid()
            for tid in tuple(tn.ind_map[ix]):
                tn.tensor_map[tid].reindex_({ix: new})
            tn.add_tensor(Tensor(to_device(G, device=self.device,
                                           dtype=psi.dtype),
                                 (ix, new, *extra),
                                 tags=[psi.site_tag(q)]), virtual=True)

        for U, where in self._queue:
            if len(where) == 1:
                add_gate(U, where[0])
                continue
            i, j = where
            if i > j:
                U, i, j = _reversed_pair(U), j, i
            # the gate factored across the bond, each piece joining its
            # own site's column
            Gl, Gr, _ = gate_split_gate(
                to_device(U, device=self.device, dtype=psi.dtype), 2, (2, 2))
            bix = rand_uuid()
            add_gate(Gl, i, (bix,))
            add_gate(Gr, j, (bix,))
        self._queue = []
        new = tensor_network_1d_compress(
            tn, max_bond=self.gate_opts.get("max_bond"),
            cutoff=self.gate_opts.get("cutoff", 1e-10),
            method=self.compress_method, site_tags=psi.site_tags,
            site_inds=psi.site_inds,
        )
        new.reindex_sites_(psi._site_ind_id)
        self._psi = new

    @property
    def psi(self):
        self.flush()
        return self._psi.copy()

    def get_psi(self):
        """The current MPS, the queue flushed first."""
        return self.psi

    def amplitude(self, b, **kwargs):
        self.flush()
        return super().amplitude(b, **kwargs)

    def to_dense(self, **kwargs):
        self.flush()
        return super().to_dense(**kwargs)

    def sample(self, C, seed=None, **kwargs):
        self.flush()
        yield from super().sample(C, seed=seed, **kwargs)

    def local_expectation(self, G, where, **kwargs):
        self.flush()
        return super().local_expectation(G, where, **kwargs)

    max_bond = property(
        lambda self: self.gate_opts.get("max_bond"),
        lambda self, v: self.gate_opts.__setitem__("max_bond", v))
    cutoff = property(
        lambda self: self.gate_opts.get("cutoff", 1e-10),
        lambda self, v: self.gate_opts.__setitem__("cutoff", v))
    method = property(
        lambda self: self.compress_method,
        lambda self, v: setattr(self, "compress_method", v))
