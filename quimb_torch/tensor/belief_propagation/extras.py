"""Further BP variants: lazy (region-grouped) BP, DIIS acceleration,
region graphs.

Re-design of reference ``l1bp.py``/``l2bp.py`` (lazy region messages),
``diis.py`` (direct inversion of the iterative subspace) and
``regions.py`` (``RegionGraph`` for generalized BP).

Port of quimb_tpu's ``tensor/belief_propagation/extras.py``: messages are
tensors on the device of the network's tensors; each message's distance
from the old one is read to the host. ``DIIS`` flattens any nest of
tensors with torch's own pytree functions.
"""

import itertools
import math

import torch
from torch.utils import _pytree as pytree

from ...ops.contraction import array_contract
from ...utils import oset
from .bp_common import (
    BeliefPropagationCommon,
    _distance,
    _network_device,
    _network_dtype,
)
from .d1bp import D1BP
from .d2bp import _apply_to_index

# HD1BP: hyper-index D1BP — the D1BP implementation here is natively
# hyper-aware (messages live on (index, tensor) slots regardless of the
# index degree), so the hyper variant is the same engine.
HD1BP = D1BP


class L1BP(BeliefPropagationCommon):
    """Lazy 1-norm BP: tensors are grouped by site tag and messages
    flow between *groups* over their (fused) connecting indices
    (reference ``l1bp.py``)."""

    def __init__(self, tn, site_tags=None, damping=0.0, update="sequential",
                 tol=5e-6, max_iterations=1000):
        super().__init__(tn, damping=damping, update=update, tol=tol,
                         max_iterations=max_iterations)
        if site_tags is None:
            site_tags = getattr(tn, "site_tags", None)
        if site_tags is None:
            raise ValueError("need site_tags for L1BP grouping")
        self.site_tags = tuple(site_tags)
        # group tids
        self.groups = {
            tag: tuple(tn._get_tids_from_tags(tag, "any"))
            for tag in self.site_tags
        }
        # bonds between groups: shared indices
        self.group_inds = {}
        for tag, tids in self.groups.items():
            inds = oset()
            for tid in tids:
                inds.update(tn.tensor_map[tid].inds)
            self.group_inds[tag] = inds
        self.links = {}
        for ta, tb in itertools.combinations(self.site_tags, 2):
            shared = tuple(
                ix for ix in self.group_inds[ta]
                if ix in self.group_inds[tb]
            )
            if shared:
                self.links[(ta, tb)] = shared
        # messages on each directed link: tensor over the shared inds
        self.messages = {}
        device, dtype = _network_device(tn), _network_dtype(tn)
        for (ta, tb), shared in self.links.items():
            dims = tuple(tn.ind_size(ix) for ix in shared)
            m = torch.ones(dims, dtype=dtype, device=device)
            m = m / torch.sum(torch.abs(m))
            self.messages[(ta, tb)] = m
            self.messages[(tb, ta)] = m

    def _neighbors(self, tag):
        out = []
        for (ta, tb) in self.links:
            if ta == tag:
                out.append(tb)
            elif tb == tag:
                out.append(ta)
        return out

    def _link(self, ta, tb):
        return self.links.get((ta, tb)) or self.links.get((tb, ta))

    def _compute_outgoing(self, tag, to_tag):
        """Contract the group's tensors with incoming messages from all
        other neighbours, lazily (one contraction per message)."""
        tn = self.tn
        arrays, inputs = [], []
        for tid in self.groups[tag]:
            t = tn.tensor_map[tid]
            arrays.append(t.data)
            inputs.append(t.inds)
        for nb in self._neighbors(tag):
            if nb == to_tag:
                continue
            shared = self._link(tag, nb)
            arrays.append(self.messages[(nb, tag)])
            inputs.append(tuple(shared))
        out_inds = tuple(self._link(tag, to_tag))
        m = array_contract(arrays, inputs, output=out_inds)
        nrm = torch.sum(torch.abs(m))
        return torch.where(nrm > 0, m / nrm, m)

    def iterate(self, tol=5e-6):
        max_dm = 0.0
        for (ta, tb) in tuple(self.messages):
            m_new = self._compute_outgoing(ta, tb)
            if self.damping:
                m_new = (1 - self.damping) * m_new + \
                    self.damping * self.messages[(ta, tb)]
                m_new = m_new / torch.sum(torch.abs(m_new))
            max_dm = max(
                max_dm, _distance(m_new, self.messages[(ta, tb)])
            )
            self.messages[(ta, tb)] = m_new
        return max_dm

    def contract(self, strip_exponent=False):
        mantissa, exponent = 1.0, 0.0
        # group contributions
        for tag in self.site_tags:
            arrays, inputs = [], []
            for tid in self.groups[tag]:
                t = self.tn.tensor_map[tid]
                arrays.append(t.data)
                inputs.append(t.inds)
            for nb in self._neighbors(tag):
                arrays.append(self.messages[(nb, tag)])
                inputs.append(tuple(self._link(tag, nb)))
            z = complex(array_contract(arrays, inputs, output=()))
            if z != 0:
                exponent += math.log10(abs(z))
                mantissa *= z / abs(z)
        # link corrections
        for (ta, tb), shared in self.links.items():
            z = complex(array_contract(
                [self.messages[(ta, tb)], self.messages[(tb, ta)]],
                [tuple(shared), tuple(shared)], output=(),
            ))
            if z != 0:
                exponent -= math.log10(abs(z))
                mantissa /= z / abs(z)
        if strip_exponent:
            return mantissa, exponent
        return mantissa * 10**exponent


def contract_l1bp(tn, site_tags=None, max_iterations=1000, tol=5e-6,
                  damping=0.0, strip_exponent=False, **kwargs):
    bp = L1BP(tn, site_tags=site_tags, damping=damping, tol=tol,
              max_iterations=max_iterations, **kwargs)
    bp.run()
    return bp.contract(strip_exponent=strip_exponent)


class L2BP(L1BP):
    """Lazy 2-norm BP: run L1BP on the sandwiched <psi|psi> network,
    grouping bra and ket tensors of each site together
    (reference ``l2bp.py``)."""

    def __init__(self, psi, site_tags=None, **kwargs):
        norm = psi.make_norm() if hasattr(psi, "make_norm") else psi
        super().__init__(
            norm,
            site_tags=site_tags or getattr(psi, "site_tags", None),
            **kwargs,
        )


def contract_l2bp(psi, site_tags=None, max_iterations=1000, tol=5e-6,
                  damping=0.0, strip_exponent=False, **kwargs):
    bp = L2BP(psi, site_tags=site_tags, damping=damping, tol=tol,
              max_iterations=max_iterations, **kwargs)
    bp.run()
    return bp.contract(strip_exponent=strip_exponent)


class DIIS:
    """Direct inversion of the iterative subspace: extrapolate a
    sequence of message/gauge vectors to accelerate fixed-point
    convergence (reference ``diis.py``)."""

    def __init__(self, max_history=6, damping=0.0):
        self.max_history = max_history
        self.damping = damping
        self._trials = []
        self._errors = []
        self._last_out = None

    def update(self, x):
        """Take the next fixed-point iterate ``x = G(previous output)``
        (a tensor or any nest of lists, tuples and dicts of tensors) and
        return the DIIS-extrapolated next point, nested as ``x``."""
        leaves, treedef = pytree.tree_flatten(x)
        flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
        if self._last_out is None:
            # first call: no residual information yet
            self._last_out = flat
            return x
        # residual of the map at the previous output
        err = flat - self._last_out
        self._trials.append(flat)
        self._errors.append(err)
        if len(self._trials) > self.max_history:
            self._trials.pop(0)
            self._errors.pop(0)
        m = len(self._trials)
        if m < 2:
            out = flat
        else:
            E = torch.stack(self._errors)  # (m, n)
            B = (E @ E.conj().T).real
            A = torch.zeros((m + 1, m + 1), dtype=B.dtype, device=B.device)
            A[:m, :m] = B
            A[m, :m] = 1.0
            A[:m, m] = 1.0
            rhs = torch.zeros((m + 1,), dtype=B.dtype, device=B.device)
            rhs[m] = 1.0
            eps = 1e-12 * (torch.trace(B) / m + 1e-300)
            A = A + eps * torch.eye(m + 1, dtype=B.dtype, device=B.device)
            c = torch.linalg.solve(A, rhs)[:m]
            xs = torch.stack(self._trials)
            out = torch.tensordot(c.to(xs.dtype), xs, dims=1)
        self._last_out = out
        outs = []
        i = 0
        for leaf in leaves:
            n = leaf.numel()
            outs.append(out[i:i + n].reshape(leaf.shape))
            i += n
        return pytree.tree_unflatten(outs, treedef)

    def reset(self):
        self._trials = []
        self._errors = []
        self._last_out = None


class RegionGraph:
    """A region graph for generalized BP: regions of tids with counting
    numbers computed by the cluster variation method (reference
    ``regions.py``, 551 LoC)."""

    def __init__(self, regions=(), autocomplete=True):
        self.lookup = {}
        self.parents = {}
        self.children = {}
        self.counts = {}
        for r in regions:
            self.add_region(r)
        if autocomplete and regions:
            self.autocomplete()

    def add_region(self, region):
        region = frozenset(region)
        if region in self.counts:
            return region
        self.counts[region] = None
        self.parents[region] = set()
        self.children[region] = set()
        for other in tuple(self.counts):
            if other == region:
                continue
            if region < other:
                self.parents[region].add(other)
                self.children[other].add(region)
            elif other < region:
                self.children[region].add(other)
                self.parents[other].add(region)
        return region

    def autocomplete(self):
        """Add all pairwise intersections recursively."""
        added = True
        while added:
            added = False
            regs = tuple(self.counts)
            for ra, rb in itertools.combinations(regs, 2):
                i = ra & rb
                if i and i not in self.counts:
                    self.add_region(i)
                    added = True
        self.compute_counts()

    def compute_counts(self):
        """Counting numbers: c_R = 1 - sum of counts of all ancestors."""
        # process by decreasing size
        for region in sorted(self.counts, key=len, reverse=True):
            anc = self.get_ancestors(region)
            self.counts[region] = 1 - sum(
                self.counts[a] for a in anc
            )

    def get_ancestors(self, region):
        out = set()
        stack = list(self.parents[region])
        while stack:
            r = stack.pop()
            if r not in out:
                out.add(r)
                stack.extend(self.parents[r])
        return out

    @property
    def regions(self):
        return tuple(self.counts)

    def get_count(self, region):
        return self.counts[frozenset(region)]

    # -- Hasse-diagram accessors for generalized BP -------------------------

    def get_direct_parents(self, region):
        """Supersets of ``region`` with no intermediate region between."""
        ps = self.parents[frozenset(region)]
        return [
            p for p in ps
            if not any(q < p for q in ps)
        ]

    def get_direct_children(self, region):
        cs = self.children[frozenset(region)]
        return [
            c for c in cs
            if not any(c < q for q in cs)
        ]

    def get_descendents(self, region):
        out = set()
        stack = list(self.children[frozenset(region)])
        while stack:
            r = stack.pop()
            if r not in out:
                out.add(r)
                stack.extend(self.children[r])
        return out

    def get_coparent_pairs(self, region):
        """All (parent, child) message pairs entering the belief of
        ``region``: direct parents of the region or of any of its
        descendants, excluding sources inside the region itself."""
        region = frozenset(region)
        pairs = [(p, region) for p in self.get_direct_parents(region)]
        rds = self.get_descendents(region)
        seen = {region, *rds}
        for rd in rds:
            for rdp in self.get_direct_parents(rd):
                if rdp not in seen:
                    pairs.append((rdp, rd))
                    seen.add(rdp)
        return pairs

    def get_message_parts(self, pair):
        """Factors and (numerator, denominator) message groups for the
        GBP update of message ``parent -> child``."""
        source, target = map(frozenset, pair)
        factors = source - target
        source_pairs = set(self.get_coparent_pairs(source))
        target_pairs = set(self.get_coparent_pairs(target))
        target_pairs.discard((source, target))
        return (
            factors,
            source_pairs - target_pairs,
            target_pairs - source_pairs,
        )

    # -- reference API parity (regions.py:66-392) ----------------------------

    def reset_info(self):
        """Recompute all counting numbers (reference ``reset_info``
        regions.py:66 clears cached region properties)."""
        self.compute_counts()

    def get_parents(self, region):
        """Direct (Hasse) parents of ``region`` (reference
        regions.py:208)."""
        return self.get_direct_parents(region)

    def get_children(self, region):
        """Direct (Hasse) children of ``region`` (reference
        regions.py:214)."""
        return self.get_direct_children(region)

    def get_maximal_regions(self):
        """Regions with no parents (reference regions.py:75)."""
        return {r for r in self.counts if not self.parents[r]}

    def get_minimal_regions(self):
        """Regions with no children (reference regions.py:79)."""
        return {r for r in self.counts if not self.children[r]}

    def get_maximal_ancestors(self, region):
        """Ancestors of ``region`` with no parents themselves
        (reference regions.py:236)."""
        return {
            a for a in self.get_ancestors(frozenset(region))
            if not self.parents[a]
        }

    def get_overlapping(self, region):
        """All other regions intersecting ``region`` (reference
        regions.py:83)."""
        region = frozenset(region)
        return {
            other for other in self.counts
            if other != region and (other & region)
        }

    def get_level(self, region):
        """Distance below the nearest parentless ancestor (reference
        regions.py:296)."""
        region = frozenset(region)
        if not self.parents[region]:
            return 0
        return min(
            self.get_level(p) for p in self.get_parents(region)
        ) - 1

    def get_total_count(self):
        """Sum of all counting numbers; 1 for a totally balanced
        graph (reference regions.py:289)."""
        self._ensure_counts()
        return sum(self.counts.values())

    def _ensure_counts(self):
        if any(c is None for c in self.counts.values()):
            self.compute_counts()

    def remove_region(self, region):
        """Remove ``region`` from the graph (reference
        regions.py:155)."""
        region = frozenset(region)
        del self.counts[region]
        for p in self.parents.pop(region):
            self.children[p].discard(region)
        for c in self.children.pop(region):
            self.parents[c].discard(region)
        return self

    def autoprune(self):
        """Remove all regions with counting number zero (reference
        regions.py:186)."""
        self._ensure_counts()
        for r in tuple(self.counts):
            if self.counts[r] == 0:
                self.remove_region(r)
        self.compute_counts()
        return self

    def autoextend(self, regions=None):
        """Extend upwards with all pairwise unions of overlapping
        regions (reference regions.py:192)."""
        if regions is None:
            regions = tuple(self.counts)
        for r in regions:
            r = frozenset(r)
            for other in tuple(self.get_overlapping(r)):
                self.add_region(r | other)
        self.compute_counts()
        return self

    def isbalanced(self):
        """Whether every variable has an overall count of 1 (reference
        regions.py:349)."""
        self._ensure_counts()
        per_node = {}
        for r, c in self.counts.items():
            for node in r:
                per_node[node] = per_node.get(node, 0) + c
        return set(per_node.values()) <= {1}

    def istotallybalanced(self):
        """Whether the total count over regions is 1 (reference
        regions.py:360)."""
        return self.get_total_count() == 1

    def check(self):
        """Consistency checks on the subset lattice (reference
        regions.py:366)."""
        for r in self.counts:
            for p in self.parents[r]:
                assert r < p
            for c in self.children[r]:
                assert c < r
            ps = self.get_parents(r)
            for pa, pb in itertools.combinations(ps, 2):
                assert not pa.issubset(pb) and not pb.issubset(pa)
        return True

    def draw(self, **kwargs):
        """Draw the region Hasse diagram, one point a region at the height
        of its level (a text listing where matplotlib fails; reference
        regions.py:392)."""
        try:
            import matplotlib.pyplot as plt

            levels = {r: self.get_level(r) for r in self.counts}
            fig, ax = plt.subplots()
            xs = {}
            for r in sorted(self.counts, key=lambda r: -len(r)):
                lv = levels[r]
                x = xs.get(lv, 0)
                xs[lv] = x + 1
                ax.scatter([x], [lv])
            return fig, ax
        except Exception:
            for r in sorted(self.counts, key=len, reverse=True):
                print(f"  level {self.get_level(r)}: "
                      f"{sorted(r, key=str)} "
                      f"(count {self.counts[r]})")
            return None

    def __repr__(self):
        return f"<RegionGraph(regions={len(self.counts)})>"


__all__ = [
    "HD1BP", "L1BP", "L2BP", "contract_l1bp", "contract_l2bp", "DIIS",
    "RegionGraph",
]


def gen_region_counts(regions, autocomplete=True):
    """Counting numbers of a set of regions via the cluster variation
    method (reference ``gen_region_counts`` regions.py:478). Returns
    ``{frozenset(region): count}`` for all (auto-completed) regions
    with nonzero counts."""
    rg = RegionGraph(regions, autocomplete=autocomplete)
    if not autocomplete:
        rg.compute_counts()
    return {
        r: c for r, c in rg.counts.items() if c
    }


def compress_l2bp(psi, max_bond, cutoff=0.0, site_tags=None,
                  max_iterations=1000, tol=5e-6, inplace=False,
                  **kwargs):
    """Compress a TN vector's bonds using converged lazy 2-norm BP
    environments as oblique projectors (reference ``compress_l2bp``
    l2bp.py:525)."""
    from ...ops import decomp

    psi = psi if inplace else psi.copy()
    bp = L2BP(psi, site_tags=site_tags, max_iterations=max_iterations,
              tol=tol, **kwargs)
    bp.run()

    psi_inds = set(psi.ind_map)

    def sqrtm_psd(m):
        m = (m + m.T.conj()) / 2
        el, V = torch.linalg.eigh(m)
        el = torch.clamp(el.real, min=0.0)
        return (V * torch.sqrt(el).to(V.dtype)) @ V.T.conj()

    for (ta, tb), shared in bp.links.items():
        ket_bonds = [ix for ix in shared if ix in psi_inds]
        if len(ket_bonds) != 1:
            continue
        (kix,) = ket_bonds
        bra_bonds = [ix for ix in shared if ix not in psi_inds]
        if len(bra_bonds) != 1:
            continue
        (bix,) = bra_bonds
        # messages over `shared` ind order
        order = list(shared)
        ki, bi = order.index(kix), order.index(bix)
        m_ab = bp.messages[(ta, tb)].permute(ki, bi)
        m_ba = bp.messages[(tb, ta)].permute(ki, bi)
        Ra = sqrtm_psd(m_ab)
        Rb = sqrtm_psd(m_ba)
        Pl, Pr = decomp.compute_oblique_projectors(
            Ra, Rb.T.conj(), max_bond=max_bond, cutoff=cutoff,
        )
        # insert Pl @ Pr on the ket bond: multiply the two psi
        # tensors holding kix
        tids = tuple(psi.ind_map[kix])
        if len(tids) != 2:
            continue
        t1 = psi.tensor_map[tids[0]]
        t2 = psi.tensor_map[tids[1]]
        # decide orientation: t in group ta gets Pl
        ta_tids = psi._get_tids_from_tags(ta, "any")
        if tids[0] in ta_tids:
            tl, tr = t1, t2
        else:
            tl, tr = t2, t1
        tl.modify(data=_apply_to_index(tl, kix, Pl, 0))
        tr.modify(data=_apply_to_index(tr, kix, Pr, 1))
    return psi
