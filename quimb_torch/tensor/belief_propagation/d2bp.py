"""D2BP: dense 2-norm belief propagation for TN vectors (PEPS-standard)
(reference ``d2bp.py``, 1911 LoC: message-projector compression,
``gauge_symmetric``).

Port of quimb_tpu's ``tensor/belief_propagation/d2bp.py``. Messages live
on the *ket* bonds but represent environments in the sandwiched
<psi|psi> network: each message is a positive (D, D) matrix on the device
of the state's tensors. One message update is one contraction and one
host read of its distance from the old message.
"""

import math

import numpy as np
import torch

from ...ops import decomp
from ...ops.backend import to_device
from ...ops.contraction import array_contract
from .bp_common import (
    BeliefPropagationCommon,
    _distance,
    _network_device,
    _network_dtype,
)
from .d1bp import _fix_most_decided


def _norm_mat(m):
    nrm = torch.abs(torch.trace(m))
    return torch.where(nrm > 0, m / nrm, m)


class D2BP(BeliefPropagationCommon):
    """2-norm BP on a TN vector: messages[ix, tid] is the (D, D)
    environment matrix sent by tensor ``tid`` along ket bond ``ix``."""

    def __init__(self, psi, messages=None, output_inds=None, damping=0.0,
                 update="sequential", tol=5e-6, max_iterations=1000,
                 **kwargs):
        super().__init__(psi, damping=damping, update=update, tol=tol,
                         max_iterations=max_iterations)
        if output_inds is None:
            output_inds = set(psi.outer_inds())
        self.output_inds = set(output_inds)
        if messages is None:
            messages = {}
            device, dtype = _network_device(psi), _network_dtype(psi)
            for ix, tids in psi.ind_map.items():
                if ix in self.output_inds or len(tids) != 2:
                    continue
                d = psi.ind_size(ix)
                for tid in tids:
                    messages[ix, tid] = torch.eye(
                        d, dtype=dtype, device=device) / d
        self.messages = messages

    def _env_terms(self, tids, skip=(), cut=()):
        """The arrays and inputs of the tensors ``tids``, their conjugates
        (a bond with messages primed ``__b__``, the indices ``cut`` primed
        ``__o__``, the rest shared with the ket) and the messages they
        receive from outside ``tids`` on their bonds other than
        ``skip``."""
        psi = self.tn
        arrays, inputs = [], []
        for tid in tids:
            t = psi.tensor_map[tid]
            arrays.append(t.data)
            inputs.append(t.inds)
        for tid in tids:
            t = psi.tensor_map[tid]
            bra = []
            for ox in t.inds:
                if ox in cut:
                    bra.append(ox + "__o__")
                elif (ox, tid) in self.messages:
                    bra.append(ox + "__b__")
                else:
                    bra.append(ox)
            arrays.append(torch.conj(t.data))
            inputs.append(tuple(bra))
        for tid in tids:
            t = psi.tensor_map[tid]
            for ox in t.inds:
                if ox in cut or ox in skip or (ox, tid) not in self.messages:
                    continue
                for otid in psi.ind_map[ox]:
                    if otid not in tids and (ox, otid) in self.messages:
                        arrays.append(self.messages[ox, otid])
                        inputs.append((ox, ox + "__b__"))
        return arrays, inputs

    def _compute_outgoing(self, tid, ix):
        """Contract t, conj(t) and incoming messages on other bonds →
        (D, D) message along ix."""
        t = self.tn.tensor_map[tid]
        ket_inds = t.inds
        # bra indices: same names except bonds with messages get primed
        bra_map = {}
        arrays = [t.data]
        inputs = [ket_inds]
        out_b = ix + "__bra__"
        for ox in ket_inds:
            if ox == ix:
                bra_map[ox] = out_b
            elif (ox, tid) in self.messages or any(
                (ox, ot) in self.messages
                for ot in self.tn.ind_map.get(ox, ())
            ):
                bra_map[ox] = ox + "__bra__"
            else:
                bra_map[ox] = ox  # physical / output: contract directly
        arrays.append(torch.conj(t.data))
        inputs.append(tuple(bra_map[ox] for ox in ket_inds))
        for ox in ket_inds:
            if ox == ix:
                continue
            for otid in self.tn.ind_map.get(ox, ()):
                if otid != tid and (ox, otid) in self.messages:
                    arrays.append(self.messages[ox, otid])
                    inputs.append((ox, ox + "__bra__"))
        out = array_contract(arrays, inputs, output=(ix, out_b))
        out = (out + out.T.conj()) / 2
        return _norm_mat(out)

    def iterate(self, tol=5e-6):
        max_dm = 0.0
        for (ix, tid) in tuple(self.messages):
            m_new = self._compute_outgoing(tid, ix)
            if self.damping:
                m_new = _norm_mat(
                    (1 - self.damping) * m_new
                    + self.damping * self.messages[ix, tid]
                )
            max_dm = max(
                max_dm, _distance(m_new, self.messages[ix, tid])
            )
            self.messages[ix, tid] = m_new
        return max_dm

    def local_expectation(self, G, where):
        """Local expectation of G on site(s) ``where`` using the BP
        environments (normalized)."""
        psi = self.tn
        if not isinstance(where, (tuple, list)):
            where = (where,)
        kix = [psi.site_ind(s) for s in where]
        tids = tuple(psi._get_tids_from_inds(kix, "any"))
        # the region's tensors and conjugates, the physical indices of
        # the conjugates cut, and the environment messages
        arrays, inputs = self._env_terms(tids, cut=kix)
        G = to_device(G, device=_network_device(psi),
                      dtype=_network_dtype(psi))
        dims = tuple(psi.ind_size(ix) for ix in kix)
        arrays.append(G.reshape(dims * 2))
        inputs.append(tuple(ix + "__o__" for ix in kix) + tuple(kix))
        num = array_contract(arrays, inputs, output=())
        # norm: the same without G, physical indices contracted directly
        arrays_n, inputs_n = self._env_terms(tids)
        den = array_contract(arrays_n, inputs_n, output=())
        return complex(num) / complex(den)

    def compute_gauges(self):
        """Symmetric bond gauges from converged messages (reference
        ``gauge_symmetric``): for each bond the singular values of
        ``sqrt(ma) sqrt(mb)``, normalised."""
        gauges = {}
        done = set()
        for (ix, tid) in self.messages:
            if ix in done:
                continue
            tids = tuple(self.tn.ind_map[ix])
            if len(tids) != 2:
                continue
            done.add(ix)
            Ra = decomp.squared_op_to_reduced_factor(
                self.messages[ix, tids[0]], right=True)
            Rb = decomp.squared_op_to_reduced_factor(
                self.messages[ix, tids[1]], right=False)
            s = torch.linalg.svdvals(Ra @ Rb)
            gauges[ix] = s / torch.linalg.vector_norm(s)
        return gauges

    def contract(self, strip_exponent=False):
        """BP estimate of <psi|psi>: prod_t Z_t / prod_bonds Z_bond on the
        doubled network."""
        mantissa, exponent = 1.0, 0.0
        psi = self.tn
        for tid in psi.tensor_map:
            arrays, inputs = self._env_terms((tid,))
            zt = complex(array_contract(arrays, inputs, output=()))
            if zt != 0:
                exponent += math.log10(abs(zt))
                mantissa *= zt / abs(zt)
        done = set()
        for (ix, tid) in self.messages:
            if ix in done:
                continue
            done.add(ix)
            tids = tuple(self.tn.ind_map[ix])
            ma = self.messages[ix, tids[0]]
            mb = self.messages[ix, tids[1]]
            zix = complex(torch.sum(ma * mb.T))
            if zix != 0:
                exponent -= math.log10(abs(zix))
                mantissa /= zix / abs(zix)
        if strip_exponent:
            return mantissa, exponent
        return mantissa * 10**exponent


def contract_d2bp(psi, max_iterations=1000, tol=5e-6, damping=0.0,
                  strip_exponent=False, **kwargs):
    bp = D2BP(psi, damping=damping, tol=tol,
              max_iterations=max_iterations, **kwargs)
    bp.run()
    return bp.contract(strip_exponent=strip_exponent)


def gauge_d2bp(psi, max_iterations=1000, tol=5e-6, damping=0.0,
               **kwargs):
    """Compute BP bond gauges for a TN vector (the 'BP gauge',
    reference ``gauge_all_belief_propagation`` tensor_core.py:7776)."""
    bp = D2BP(psi, damping=damping, tol=tol,
              max_iterations=max_iterations, **kwargs)
    bp.run()
    return bp.compute_gauges()


def _apply_to_index(t, ix, M, axis):
    """Contract index ``ix`` of tensor ``t`` with axis ``axis`` of the
    matrix ``M``, the new index in ``ix``'s place."""
    ax = t.inds.index(ix)
    d = torch.tensordot(t.data, M, dims=([ax], [axis]))
    return torch.movedim(d, -1, ax)


def compress_d2bp(psi, max_bond, cutoff=0.0, max_iterations=1000,
                  tol=5e-6, inplace=False, **kwargs):
    """Compress all bonds of a TN vector using BP message projectors
    (reference compress_d2bp)."""
    psi = psi if inplace else psi.copy()
    bp = D2BP(psi, tol=tol, max_iterations=max_iterations, **kwargs)
    bp.run()
    done = set()
    for (ix, tid) in tuple(bp.messages):
        if ix in done:
            continue
        tids = tuple(psi.ind_map[ix])
        if len(tids) != 2:
            continue
        done.add(ix)
        Ra = decomp.squared_op_to_reduced_factor(
            bp.messages[ix, tids[0]], right=True)
        Rb = decomp.squared_op_to_reduced_factor(
            bp.messages[ix, tids[1]], right=False)
        Pl, Pr = decomp.compute_oblique_projectors(
            Ra, Rb, max_bond=max_bond, cutoff=cutoff,
        )
        # insert Pl @ Pr on the bond
        t0 = psi.tensor_map[tids[0]]
        t1 = psi.tensor_map[tids[1]]
        t0.modify(data=_apply_to_index(t0, ix, Pl, 0))
        t1.modify(data=_apply_to_index(t1, ix, Pr, 1))
    return psi


def _d2bp_marginal(bp, ix):
    """Diagonal of the BP reduced density matrix on output index
    ``ix``."""
    psi = bp.tn
    (tid,) = psi.ind_map[ix]
    t = psi.tensor_map[tid]
    arrays = [t.data]
    inputs = [t.inds]
    bra_inds = []
    for ox in t.inds:
        if ox == ix or any(
            (ox, otid) in bp.messages
            for otid in psi.ind_map.get(ox, ())
        ):
            bra_inds.append(ox + "__bra__")
        else:
            bra_inds.append(ox)
    arrays.append(torch.conj(t.data))
    inputs.append(tuple(bra_inds))
    for ox in t.inds:
        if ox == ix:
            continue
        for otid in psi.ind_map.get(ox, ()):
            if otid != tid and (ox, otid) in bp.messages:
                arrays.append(bp.messages[ox, otid])
                inputs.append((ox, ox + "__bra__"))
    rho = array_contract(arrays, inputs, output=(ix, ix + "__bra__"))
    p = torch.clamp(torch.diagonal(rho).real, min=0.0)
    return p / torch.sum(p)


def sample_d2bp(tn, output_inds=None, messages=None,
                max_iterations=100, tol=1e-2, bias=None, seed=None,
                damping=0.0, update="sequential", local_convergence=True,
                progbar=False, **kwargs):
    """Sample a computational-basis configuration of a TN *vector*
    via 2-norm BP marginals: repeatedly fix the most decided output
    index and re-converge the messages (reference ``sample_d2bp``
    d2bp.py:1734). The draws come from ``np.random.default_rng(seed)``,
    as in quimb_tpu.

    Returns ``(config, tn_config, omega)``.
    """
    rng = np.random.default_rng(seed)
    tn = tn.copy()
    if output_inds is None:
        output_inds = tn.outer_inds()
    remaining = set(output_inds)
    config = {}
    omega = 1.0

    while remaining:
        bp = D2BP(tn, messages=messages, damping=damping,
                  update=update, max_iterations=max_iterations,
                  tol=tol, output_inds=remaining, **kwargs)
        bp.run()
        marginals = {ix: _d2bp_marginal(bp, ix) for ix in remaining}
        ix, v, pv = _fix_most_decided(marginals, rng, bias)
        config[ix] = v
        omega *= pv
        tn.isel_({ix: v})
        remaining.discard(ix)
        # warm start the next run with the still-valid messages
        messages = {
            k: m for k, m in bp.messages.items()
            if k[0] in tn.ind_map
        }
    return config, tn, omega
