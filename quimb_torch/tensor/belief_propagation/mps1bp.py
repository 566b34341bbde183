"""Belief propagation with MPS messages (reference
``quimb/experimental/belief_propagation/mps1bp.py`` ``MPS1BP`` :12).

For tensor networks with a 'graph + 1' structure — a site geometry
(``site_tags``) repeated in layers (``layer_tags``), e.g. a PEPS norm
sandwich or a quasi-2D partition function — the messages between site
groups are not single tensors but chains of tensors over the layers.
``MPS1BP`` keeps each message as a bounded-bond MPS over
``layer_tags``, compressed after every update: exponentially more
expressive than D1BP/L1BP point messages at linear extra cost.

Port of quimb_tpu's ``tensor/belief_propagation/mps1bp.py``: each message
update is one contraction and a canonize / compress sweep of the small
layer chain on the device of the network's tensors; a message's norm and
its distance from the old message are read to the host.
"""

import itertools
import math

from ...utils import oset
from ..core import (
    TensorNetwork,
    bonds,
    tensor_canonize_bond,
    tensor_compress_bond,
)
from .bp_common import BeliefPropagationCommon


class MPS1BP(BeliefPropagationCommon):
    """1-norm lazy BP with MPS (layer-chain) messages (reference
    ``MPS1BP`` experimental/belief_propagation/mps1bp.py:12).

    Parameters
    ----------
    tn : TensorNetwork
        Should have a 'graph + 1' structure: sites given by
        ``site_tags`` repeated in layers given by ``layer_tags`` (each
        tensor has exactly one layer tag).
    max_bond : int
        Maximum bond dimension of the MPS messages.
    layer_tags : sequence[str]
        The tags identifying the layers ('+1' direction).
    site_tags : sequence[str], optional
        The tags identifying the site groups (defaults to
        ``tn.site_tags``).
    cutoff : float, optional
        Singular value cutoff for message compression.
    """

    def __init__(self, tn, max_bond, layer_tags, site_tags=None, *,
                 cutoff=0.0, damping=0.0, update="sequential",
                 tol=5e-6, max_iterations=1000):
        if damping != 0.0:
            raise NotImplementedError(
                "MPS1BP does not support damping"
            )
        super().__init__(tn, damping=damping, update=update, tol=tol,
                         max_iterations=max_iterations)
        if site_tags is None:
            site_tags = tuple(tn.site_tags)
        self.site_tags = tuple(site_tags)
        self.layer_tags = tuple(layer_tags)
        self.max_bond = max_bond
        self.cutoff = cutoff

        # group the tensors by site tag; local TNs have the bonds to
        # neighbouring groups as their outer indices
        self.local_tns = {}
        group_inds = {}
        for tag in self.site_tags:
            ltn = tn.select(tag, which="any").copy()
            self.local_tns[tag] = ltn
            inds = oset()
            for t in ltn.tensor_map.values():
                inds.update(t.inds)
            group_inds[tag] = inds

        # links between groups = shared indices
        self.links = {}
        self.neighbors = {tag: [] for tag in self.site_tags}
        for ta, tb in itertools.combinations(self.site_tags, 2):
            shared = tuple(
                ix for ix in group_inds[ta] if ix in group_inds[tb]
            )
            if shared:
                self.links[(ta, tb)] = shared
                self.neighbors[ta].append(tb)
                self.neighbors[tb].append(ta)

        # initialize messages: local TN with non-target bonds
        # sum-reduced, contracted to one tensor per layer
        self.messages = {}
        for (ta, tb) in self.links:
            for a, b in ((ta, tb), (tb, ta)):
                self.messages[(a, b)] = self._initial_message(a, b)

    def _link_inds(self, a, b):
        return self.links.get((a, b)) or self.links.get((b, a))

    def _initial_message(self, a, b):
        bix = set(self._link_inds(a, b))
        m = self.local_tns[a].copy()
        for t in m.tensor_map.values():
            for ix in tuple(t.inds):
                if ix not in bix and ix in m.outer_inds():
                    t.sum_reduce_(ix)
        self._to_layer_chain(m)
        return self._normalize(m)

    def _to_layer_chain(self, m):
        """Contract ``m`` to one tensor per layer tag, dropping all
        other tags so messages compose cleanly."""
        for ltag in self.layer_tags:
            if ltag in m.tag_map and len(m.tag_map[ltag]) > 1:
                m.contract_tags_(ltag, which="any")
            if ltag in m.tag_map:
                (tid,) = m.tag_map[ltag]
                m.tensor_map[tid].modify(tags=(ltag,))
        return m

    def _layer_tensors(self, m):
        out = []
        for ltag in self.layer_tags:
            if ltag in m.tag_map:
                (tid,) = m.tag_map[ltag]
                out.append(m.tensor_map[tid])
        return out

    def _compress(self, m):
        """Bounded-bond compression of the layer chain: right-canonize
        sweep then left-to-right truncating sweep (the 'direct'
        1D-compression method on the layer axis)."""
        ts = self._layer_tensors(m)
        # right-to-left canonize
        for i in range(len(ts) - 1, 0, -1):
            if bonds(ts[i - 1], ts[i]):
                tensor_canonize_bond(ts[i], ts[i - 1], absorb="right")
        # left-to-right compress
        for i in range(len(ts) - 1):
            if bonds(ts[i], ts[i + 1]):
                tensor_compress_bond(
                    ts[i], ts[i + 1], max_bond=self.max_bond,
                    cutoff=self.cutoff, absorb="right",
                )
        return m

    def _normalize(self, m):
        nrm = abs(complex(self._overlap(m, m))) ** 0.5
        if nrm > 0:
            m.multiply_(1 / nrm, spread_over=len(m.tensor_map))
        return m

    @staticmethod
    def _overlap(ma, mb):
        """<ma|mb> over their shared outer indices."""
        maH = ma.conj()
        maH.mangle_inner_("*")
        return TensorNetwork((maH, mb)).contract(output_inds=())

    def compute_message(self, a, b):
        """New message a -> b: local TN at ``a`` fused with all
        incoming messages except from ``b``, compressed to an MPS over
        the layer tags."""
        parts = [self.local_tns[a].copy()]
        for c in self.neighbors[a]:
            if c != b:
                parts.append(self.messages[(c, a)].copy())
        m = TensorNetwork(parts, virtual=True)
        self._to_layer_chain(m)
        self._compress(m)
        return self._normalize(m)

    def _distance(self, ma, mb):
        """L2 distance between two (normalized) message chains."""
        aa = complex(self._overlap(ma, ma))
        bb = complex(self._overlap(mb, mb))
        ab = complex(self._overlap(ma, mb))
        return abs(abs(aa) + abs(bb) - 2 * ab.real) ** 0.5

    def iterate(self, tol=None):
        tol = tol if tol is not None else self.tol
        max_mdiff = 0.0
        keys = list(self.messages)
        if self.update == "parallel":
            new = {k: self.compute_message(*k) for k in keys}
            for k, m in new.items():
                max_mdiff = max(
                    max_mdiff, self._distance(self.messages[k], m)
                )
                self.messages[k] = m
        else:
            for k in keys:
                m = self.compute_message(*k)
                max_mdiff = max(
                    max_mdiff, self._distance(self.messages[k], m)
                )
                self.messages[k] = m
        return max_mdiff

    def contract(self, strip_exponent=False):
        """BP estimate of the full contraction: product of local
        cluster contractions divided by message overlaps."""
        mantissa, exponent = 1.0, 0.0
        for a in self.site_tags:
            tn_am = TensorNetwork((
                self.local_tns[a],
                *(self.messages[(b, a)] for b in self.neighbors[a]),
            ))
            za = complex(tn_am.contract(output_inds=()))
            if za == 0:
                return 0.0
            mantissa *= za / abs(za)
            exponent += math.log10(abs(za))
        for (a, b) in self.links:
            # plain contraction of the two messages (no conjugation —
            # the message cluster, reference mps1bp.py:258)
            zab = complex(TensorNetwork((
                self.messages[(a, b)], self.messages[(b, a)]
            )).contract(output_inds=()))
            if zab == 0:
                return 0.0
            mantissa /= zab / abs(zab)
            exponent -= math.log10(abs(zab))
        if strip_exponent:
            return mantissa, exponent
        return mantissa * 10.0**exponent


def contract_mps1bp(tn, max_bond, layer_tags, site_tags=None,
                    max_iterations=1000, tol=5e-6, **kwargs):
    """One-shot MPS-message BP contraction estimate."""
    bp = MPS1BP(tn, max_bond, layer_tags, site_tags=site_tags,
                max_iterations=max_iterations, tol=tol, **kwargs)
    bp.run()
    return bp.contract()


__all__ = ["MPS1BP", "contract_mps1bp"]
