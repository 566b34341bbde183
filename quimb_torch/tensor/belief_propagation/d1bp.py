"""D1BP: dense 1-norm belief propagation on a closed tensor network
(reference ``d1bp.py``). Estimates contracted values (partition
functions / amplitudes) as products of local contractions.

Port of quimb_tpu's ``tensor/belief_propagation/d1bp.py``: one message
update is one contraction on the device of the network's tensors, and one
host read of its distance from the old message.
"""

import math

import numpy as np
import torch

from ...ops.backend import to_host
from ...ops.contraction import array_contract
from .bp_common import (
    BeliefPropagationCommon,
    _distance,
    initialize_messages,
    normalize_message,
)


class D1BP(BeliefPropagationCommon):
    """Belief propagation with vector messages on each (index, tensor)
    pair of a closed TN (hyper indices supported)."""

    def __init__(self, tn, messages=None, damping=0.0, update="sequential",
                 tol=5e-6, max_iterations=1000, local_convergence=True):
        super().__init__(tn, damping=damping, update=update, tol=tol,
                         max_iterations=max_iterations)
        self.messages = messages if messages is not None else \
            initialize_messages(tn)
        self.exponent = 0.0

    def _incoming(self, tid, skip=None):
        """The arrays and inputs of tensor ``tid`` and of the messages it
        receives on its indices other than ``skip``."""
        t = self.tn.tensor_map[tid]
        arrays = [t.data]
        inputs = [t.inds]
        for ox in t.inds:
            if ox == skip:
                continue
            # incoming messages on ox from all OTHER tensors holding ox
            for otid in self.tn.ind_map[ox]:
                if otid != tid:
                    arrays.append(self.messages[ox, otid])
                    inputs.append((ox,))
        return arrays, inputs

    def _compute_outgoing(self, tid, ix):
        """Message from tensor ``tid`` along index ``ix``: contract the
        tensor with all incoming messages on its other indices."""
        arrays, inputs = self._incoming(tid, skip=ix)
        return normalize_message(array_contract(arrays, inputs,
                                                output=(ix,)))

    def iterate(self, tol=5e-6):
        max_dm = 0.0
        new = {}
        # messages[ix, tid] is the message sent BY tid along ix
        for (ix, tid) in self.messages:
            m_new = self._compute_outgoing(tid, ix)
            if self.damping:
                m_new = normalize_message(
                    (1 - self.damping) * m_new
                    + self.damping * self.messages[ix, tid])
            if self.update == "sequential":
                max_dm = max(
                    max_dm, _distance(m_new, self.messages[ix, tid])
                )
                self.messages[ix, tid] = m_new
            else:
                new[ix, tid] = m_new
        if self.update != "sequential":
            for k, m in new.items():
                max_dm = max(max_dm, _distance(m, self.messages[k]))
            self.messages.update(new)
        return max_dm

    def local_tensor_contraction(self, tid):
        """Z_t: tensor contracted with all its incoming messages."""
        arrays, inputs = self._incoming(tid)
        return array_contract(arrays, inputs, output=())

    def local_index_contraction(self, ix):
        """Z_ix: product of all messages meeting at index ix."""
        tids = tuple(self.tn.ind_map[ix])
        arrays = [self.messages[ix, tid] for tid in tids]
        inputs = [(ix,) for _ in tids]
        return array_contract(arrays, inputs, output=())

    def contract(self, strip_exponent=False):
        """BP estimate of the full contraction:
        Z = prod_t Z_t / prod_ix Z_ix^(d - 1) (reference d1bp contract)."""
        mantissa = 1.0
        exponent = 0.0
        for tid in self.tn.tensor_map:
            zt = complex(self.local_tensor_contraction(tid))
            if zt != 0:
                exponent += math.log10(abs(zt))
                mantissa *= zt / abs(zt)
        for ix, tids in self.tn.ind_map.items():
            if len(tids) < 2:
                continue
            # Bethe free energy: an index of degree d contributes
            # Z_ix^-(d-1)
            zix = complex(self.local_index_contraction(ix))
            if zix != 0:
                dm1 = len(tids) - 1
                exponent -= dm1 * math.log10(abs(zix))
                mantissa /= (zix / abs(zix)) ** dm1
        if strip_exponent:
            return mantissa, exponent
        return mantissa * 10**exponent


def contract_d1bp(tn, max_iterations=1000, tol=5e-6, damping=0.0,
                  strip_exponent=False, **kwargs):
    """Estimate a TN's contraction via D1BP."""
    bp = D1BP(tn, damping=damping, tol=tol,
              max_iterations=max_iterations, **kwargs)
    bp.run()
    return bp.contract(strip_exponent=strip_exponent)


def contract_hd1bp(tn, messages=None, max_iterations=1000, tol=5e-6,
                   damping=0.0, strip_exponent=False, **kwargs):
    """Hyper-index 1-norm BP contraction estimate (reference
    ``contract_hd1bp`` hd1bp.py:443; D1BP here is natively hyper-index
    aware)."""
    bp = D1BP(tn, messages=messages, damping=damping,
              max_iterations=max_iterations, tol=tol, **kwargs)
    bp.run()
    return bp.contract(strip_exponent=strip_exponent)


def _d1bp_marginal(bp, ix):
    """Normalised marginal over index ``ix``: the product of the outgoing
    messages from every tensor holding it."""
    m = None
    for tid in tuple(bp.tn.ind_map[ix]):
        out = bp._compute_outgoing(tid, ix)
        m = out if m is None else m * out
    p = torch.clamp(m.real, min=0.0)
    return p / torch.sum(p)


def _fix_most_decided(marginals, rng, bias):
    """Draw a value of the index whose marginal has the largest entry:
    ``(index, value, probability)``, the draw from ``rng`` as quimb_tpu
    makes it, from the marginal (to the power ``bias``) renormalised in
    float64."""
    ix, p = max(marginals.items(), key=lambda kv: float(torch.max(kv[1])))
    p = np.asarray(to_host(p), dtype=np.float64)
    if bias is not None:
        p = p**bias
    p = p / p.sum()
    v = int(rng.choice(p.size, p=p))
    return ix, v, float(p[v])


def sample_hd1bp(tn, messages=None, output_inds=None, max_iterations=1000,
                 tol=1e-2, damping=0.0, seed=None, bias=None,
                 progbar=False, **kwargs):
    """Sample a configuration of ``output_inds`` using hyper 1-norm BP
    marginals, fixing the most decided index each round and re-running
    BP (reference ``sample_hd1bp`` hd1bp.py:604). The draws come from
    ``np.random.default_rng(seed)``, as in quimb_tpu.

    Returns
    -------
    config : dict[str, int]
        The sampled value of each index.
    tn_config : TensorNetwork
        The network with the sampled indices fixed.
    omega : float
        The probability the sampler assigned to this configuration.
    """
    rng = np.random.default_rng(seed)
    tn = tn.copy()
    if output_inds is None:
        # default: sample every index (for a closed hyper TN each
        # index is one classical variable)
        output_inds = set(tn.ind_map)
    remaining = set(output_inds)
    config = {}
    omega = 1.0

    while remaining:
        bp = D1BP(tn, damping=damping, max_iterations=max_iterations,
                  tol=tol, **kwargs)
        bp.run()
        marginals = {ix: _d1bp_marginal(bp, ix) for ix in remaining}
        ix, v, pv = _fix_most_decided(marginals, rng, bias)
        config[ix] = v
        omega *= pv
        tn.isel_({ix: v})
        remaining.discard(ix)
    return config, tn, omega
