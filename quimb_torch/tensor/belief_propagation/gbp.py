"""Generalized belief propagation on region graphs for hyper tensor
networks (reference ``quimb/experimental/belief_propagation/hd1gbp.py``).

Regions mix tensor ids and index names; messages flow from direct
parents to children over the region Hasse diagram, with the standard
parent-to-child update (source belief factors and coparent messages in
the numerator, target coparent messages in the denominator). The free
energy / partition function estimate is the count-weighted product of
region-belief contractions (cluster variation method).

Port of quimb_tpu's ``tensor/belief_propagation/gbp.py``: messages are
tensors on the device of the network's tensors; each message's distance
from the old one is read to the host.
"""

import math

import torch

from ..core import Tensor, tensor_contract
from .bp_common import (
    BeliefPropagationCommon,
    _distance,
    _network_device,
    _network_dtype,
)
from .extras import RegionGraph

__all__ = ["HD1GBP", "contract_hd1gbp"]


def auto_add_indices(tn, regions):
    """Complete each region with all indices incident to its tids
    (region elements may be tensor ids or index names)."""
    out = []
    for r in regions:
        r = set(r)
        for x in tuple(r):
            if x in tn.tensor_map:
                r.update(tn.tensor_map[x].inds)
        out.append(frozenset(r))
    return out


class HD1GBP(BeliefPropagationCommon):
    """Generalized BP over a region graph of ``tn``.

    Parameters
    ----------
    tn : TensorNetwork
        A (hyper) tensor network; commonly a classical partition
        function or a factor graph.
    regions : sequence[set[int | str]]
        Base regions: sets of tensor ids and/or index names. Indices of
        any included tid are added automatically.
    """

    def __init__(self, tn, regions, *, autocomplete=True, damping=0.5,
                 optimize=None, **kwargs):
        super().__init__(tn, damping=damping, **kwargs)
        regions = auto_add_indices(tn, regions)
        self.rg = RegionGraph(regions, autocomplete=autocomplete)
        self.messages = {}
        self.new_messages = {}
        self.optimize = optimize

    def _message_tensors(self, source, target):
        factors, pairs_mul, pairs_div = self.rg.get_message_parts(
            (source, target)
        )
        ts = [
            self.tn.tensor_map[x] for x in factors
            if x in self.tn.tensor_map
        ]
        for pair in pairs_mul:
            m = self.messages.get(pair)
            if m is not None:
                ts.append(m)
        for pair in pairs_div:
            # GBP stability: divide by the freshest available message
            m = self.new_messages.get(pair, self.messages.get(pair))
            if m is not None:
                ts.append(Tensor(1.0 / m.data, inds=m.inds))
        return ts

    def compute_message(self, source, target):
        ts = self._message_tensors(source, target)
        if not ts:
            return Tensor(torch.ones((), dtype=_network_dtype(self.tn),
                                     device=_network_device(self.tn)))
        output_inds = tuple(sorted(
            {ix for t in ts for ix in t.inds} & set(target)
        ))
        m = tensor_contract(
            *ts, output_inds=output_inds, preserve_tensor=True,
            optimize=self.optimize,
        )
        nrm = torch.sum(torch.abs(m.data))
        m.modify(apply=lambda d, nrm=nrm: d / torch.where(
            nrm > 0, nrm, torch.ones_like(nrm)))
        m.drop_tags()
        return m

    def iterate(self, tol=5e-6):
        max_mdiff = 0.0
        # update messages into smaller regions first
        for child in sorted(self.rg.regions, key=len):
            for parent in self.rg.get_direct_parents(child):
                m = self.compute_message(parent, child)
                self.new_messages[parent, child] = m
                m_old = self.messages.get((parent, child))
                if m_old is None or m_old.shape != m.shape:
                    mdiff = 1.0
                else:
                    mdiff = _distance(m_old.data, m.data)
                max_mdiff = max(max_mdiff, mdiff)
        for pair, m in self.new_messages.items():
            m_old = self.messages.get(pair)
            if (
                self.damping
                and m_old is not None
                and m_old.shape == m.shape
            ):
                self.messages[pair] = Tensor(
                    self.damping * m_old.data
                    + (1 - self.damping) * m.data,
                    inds=m.inds,
                )
            else:
                self.messages[pair] = m
        return max_mdiff

    def _belief_tensors(self, region):
        ts = [
            self.tn.tensor_map[x] for x in region
            if x in self.tn.tensor_map
        ]
        for pair in self.rg.get_coparent_pairs(region):
            m = self.messages.get(pair)
            if m is not None:
                ts.append(m)
        return ts

    def contract(self, strip_exponent=False):
        """Estimate the TN contraction (partition function): the
        count-weighted product of region-belief contractions."""
        mantissa, exponent = 1.0, 0.0
        for region in self.rg.regions:
            c = self.rg.get_count(region)
            if c == 0:
                continue
            ts = self._belief_tensors(region)
            if not ts:
                continue
            zr = complex(tensor_contract(
                *ts, output_inds=(), optimize=self.optimize,
            ))
            if zr == 0:
                return (0.0, 0.0) if strip_exponent else 0.0
            mag = abs(zr)
            mantissa *= (zr / mag) ** c
            exponent += c * math.log10(mag)
        if strip_exponent:
            return mantissa, exponent
        return mantissa * 10.0 ** exponent


def contract_hd1gbp(tn, regions, max_iterations=500, tol=5e-6,
                    damping=0.5, strip_exponent=False, **kwargs):
    """Contract a hyper TN via generalized BP over ``regions``."""
    bp = HD1GBP(tn, regions, damping=damping, **kwargs)
    bp.run(max_iterations=max_iterations, tol=tol)
    return bp.contract(strip_exponent=strip_exponent)
