"""Arbitrary-geometry tensor networks.

Port of quimb_tpu's ``tensor/tnag/core.py`` (reference
``quimb/tensor/tnag/core.py``: ``TensorNetworkGen`` :806,
``TensorNetworkGenVector`` :1700 with exact and cluster local
expectations :2121, :2425, ``TensorNetworkGenOperator`` :3690) and the
simple-gauge machinery (``gauge_all_simple``, tensor_core.py:7555) it
builds on. Every operation runs on the device of the network's tensors;
a gauge vector lives beside the tensors it scales. ``gauge_all_simple``
reads the largest change of the gauges once an iteration (quimb_tpu reads
each gauge's norm and change), and each bond's split reads its kept rank.

Local expectations come as ``'exact'`` (the whole network contracted
with the operator inserted) and ``'cluster'`` (a graph-distance-``r``
neighbourhood, its outer bonds capped with the simple-update gauges).
``compute_local_expectation(executor=)`` submits each term to a
``concurrent.futures`` executor; the contraction expressions' cache is
shared under a lock (:mod:`quimb_torch.ops.contraction`). The loop
expansions (``'gloop-expand'``, ``'sloop-expand'`` and
``norm_gloop_expand``) weight gauge-capped cluster estimates over
loop-extended regions by the counting numbers of belief propagation's
``RegionGraph``.
"""

import collections
import functools
import itertools
import math

import numpy as np
import torch

from ...ops.backend import to_host
from ...utils import oset
from ..core import (
    Tensor,
    TensorNetwork,
    bonds,
    rand_uuid,
)


def _operator_like(G, tn):
    """The operator ``G`` (a tensor or an array-like) on the device and in
    the dtype of ``tn``'s tensors; a complex ``G`` on a real network keeps
    its real part (quimb_tpu's ``jnp.asarray(G, dtype=...)``)."""
    ref = next(iter(tn.tensor_map.values())).data
    if isinstance(ref, np.ndarray):
        g = np.asarray(to_host(G))
        return (g if np.iscomplexobj(ref) else g.real).astype(ref.dtype)
    if not isinstance(G, torch.Tensor):
        G = torch.as_tensor(np.array(G))
    if G.is_complex() and not ref.is_complex():
        G = G.real
    return G.to(device=ref.device, dtype=ref.dtype)


def edge_coloring(edges, strategy="smallest_last"):
    """Group edges into 'colors' such that no two edges in a color
    share a site (reference ``edge_coloring`` tnag/tebd.py:24) —
    gates within one color commute and can be applied in parallel."""
    edges = list(edges)
    colors = []
    remaining = list(edges)
    while remaining:
        used = set()
        this_color = []
        rest = []
        for e in remaining:
            a, b = e
            if a in used or b in used:
                rest.append(e)
            else:
                this_color.append(e)
                used.add(a)
                used.add(b)
        colors.append(this_color)
        remaining = rest
    return colors


class TensorNetworkGen(TensorNetwork):
    """TN with a notion of 'sites' of arbitrary (hashable) labels."""

    _EXTRA_PROPS = ("_sites", "_site_tag_id")

    @property
    def sites(self):
        return self._sites

    @property
    def nsites(self):
        return len(self._sites)

    @property
    def site_tag_id(self):
        return self._site_tag_id

    def site_tag(self, site):
        return self._site_tag_id.format(site)

    @property
    def site_tags(self):
        return tuple(map(self.site_tag, self._sites))

    def maybe_convert_coo(self, x):
        if x in self._sites if isinstance(x, (int, str, tuple)) else False:
            return self.site_tag(x)
        return x

    def gen_bonds(self):
        """Yield pairs of sites connected by at least one index."""
        seen = set()
        for site_a in self._sites:
            ta = self.select_tensors(self.site_tag(site_a), "any")
            inds_a = oset()
            for t in ta:
                inds_a.update(t.inds)
            for site_b in self._sites:
                if site_b == site_a or (site_b, site_a) in seen:
                    continue
                tb = self.select_tensors(self.site_tag(site_b), "any")
                if any(ix in inds_a for t in tb for ix in t.inds):
                    seen.add((site_a, site_b))
                    yield (site_a, site_b)

    def neighbors(self, site):
        """Sites sharing a bond with ``site``."""
        out = []
        ts = self.select_tensors(self.site_tag(site), "any")
        inds = oset()
        for t in ts:
            inds.update(t.inds)
        for other in self._sites:
            if other == site:
                continue
            to = self.select_tensors(self.site_tag(other), "any")
            if any(ix in inds for t in to for ix in t.inds):
                out.append(other)
        return out

    def gen_sites_present(self):
        """Yield the sites which currently have tensors (reference
        ``gen_sites_present`` tnag/core.py)."""
        for site in self._sites:
            if self.site_tag(site) in self.tag_map:
                yield site

    def _site_neighborhood(self, sites, max_distance=1):
        """All sites within graph distance ``max_distance``."""
        frontier = set(sites)
        seen = set(sites)
        for _ in range(max_distance):
            new = set()
            for s in frontier:
                new.update(self.neighbors(s))
            new -= seen
            seen |= new
            frontier = new
        return seen


class TensorNetworkGenVector(TensorNetworkGen):
    """Arbitrary-geometry TN state with one physical index per site
    (reference ``TensorNetworkGenVector`` tnag/core.py:1700)."""

    _EXTRA_PROPS = ("_sites", "_site_tag_id", "_site_ind_id")

    @property
    def site_ind_id(self):
        return self._site_ind_id

    @site_ind_id.setter
    def site_ind_id(self, new_id):
        if new_id != self._site_ind_id:
            self.reindex_sites_(new_id)
            self._site_ind_id = new_id

    def reindex_sites(self, new_id, where=None, inplace=False):
        """Reindex the site indices to a new format string ``new_id``
        (optionally only at ``where`` sites)."""
        if where is None:
            where = self.gen_sites_present()
        tn = self if inplace else self.copy()
        tn.reindex_(
            {self.site_ind(s): new_id.format(s) for s in where}
        )
        return tn

    reindex_sites_ = functools.partialmethod(reindex_sites, inplace=True)

    def site_ind(self, site):
        return self._site_ind_id.format(site)

    @property
    def site_inds(self):
        return tuple(map(self.site_ind, self._sites))

    def phys_dim(self, site=None):
        if site is None:
            site = self._sites[0]
        return self.ind_size(self.site_ind(site))

    def to_dense(self, *inds_seq, **contract_opts):
        if not inds_seq:
            # default: one group -> a ket-shaped column vector
            inds_seq = (self.site_inds,)
            t = self.contract(
                ..., output_inds=tuple(
                    ix for g in inds_seq for ix in g
                ), preserve_tensor=True, **contract_opts,
            )
            return t.data.reshape(-1, 1)
        # explicit groups: honor them exactly (reference delegates to
        # the base TensorNetwork.to_dense, tnag/core.py:1815)
        return TensorNetwork.to_dense(self, *inds_seq,
                                      **contract_opts)

    def gate(self, G, where, contract="reduce-split", tags=None,
             inplace=False, **opts):
        from ..gating import tensor_network_gate_inds

        if not isinstance(where, (tuple, list)):
            where = (where,)
        inds = tuple(self.site_ind(s) for s in where)
        psi = self if inplace else self.copy()
        if len(inds) == 1:
            contract = True
        tensor_network_gate_inds(
            psi, G, inds, contract=contract, tags=tags, inplace=True,
            **opts,
        )
        return psi

    gate_ = functools.partialmethod(gate, inplace=True)

    def make_norm(self, layer_tags=("KET", "BRA")):
        ket = self.copy()
        ket.add_tag(layer_tags[0])
        bra = ket.H
        bra.retag_({layer_tags[0]: layer_tags[1]})
        bra.mangle_inner_("*")
        norm = ket & bra
        norm.view_like_(self)
        return norm

    # -- gauging -------------------------------------------------------------

    def gauge_all_simple(self, max_iterations=100, tol=1e-9, smudge=1e-12,
                         gauges=None, inplace=False, info=None):
        """Iteratively simple-gauge every bond (Vidal form) until the
        gauges converge (reference ``gauge_all_simple``
        tensor_core.py:7555). Returns ``tn``. If ``gauges`` is
        supplied (possibly empty) it is filled in place and left
        stripped from the network (Vidal form); otherwise the gauges
        are reabsorbed so the network value is preserved, matching the
        reference convention.

        If ``info`` (a dict) is passed, ``info['log_scale']`` receives
        the accumulated log of the norms stripped from each extracted
        singular-value vector — needed to reconstruct *absolute*
        norms from the gauged representation (expectation ratios don't
        need it)."""
        tn = self if inplace else self.copy()
        from ..core import tensor_compress_bond

        log_scale = 0.0
        gauges_supplied = gauges is not None
        if not gauges_supplied:
            gauges = {}
        # collect bonds (index names shared by exactly two tensors)
        bnds = [
            ix for ix, tids in tn.ind_map.items() if len(tids) == 2
        ]
        for it in range(max_iterations):
            # the changes of the gauges stay on the device until the end of
            # the iteration: one host read an iteration
            diffs, resized = [], False
            for ix in bnds:
                tids = tuple(tn.ind_map.get(ix, ()))
                if len(tids) != 2:
                    continue
                t1, t2 = (tn.tensor_map[t] for t in tids)
                # absorb environment gauges on other bonds
                absorbed = []
                for t in (t1, t2):
                    for ox in t.inds:
                        if ox != ix and ox in gauges:
                            t.multiply_index_diagonal_(
                                ox, gauges[ox] + smudge
                            )
                            absorbed.append((t, ox))
                if ix in gauges:
                    s_old = gauges[ix]
                    t1.multiply_index_diagonal_(ix, torch.sqrt(s_old))
                    t2.multiply_index_diagonal_(ix, torch.sqrt(s_old))
                else:
                    s_old = None
                out = tensor_compress_bond(
                    t1, t2, absorb=None, cutoff=0.0,
                )
                if len(out) == 3:
                    _, s, _ = out
                    ns = torch.linalg.norm(s)
                    log_scale = log_scale + torch.where(
                        ns > 0, torch.log(ns), 0.0)
                    s = s / ns
                    gauges[ix] = s
                    if s_old is not None and s.shape == s_old.shape:
                        diffs.append((s - s_old).abs().max())
                    else:
                        resized = True
                for (t, ox) in absorbed:
                    t.multiply_index_diagonal_(
                        ox, 1 / (gauges[ox] + smudge)
                        if ox in gauges else 1.0
                    )
            max_diff = 1.0 if resized else 0.0
            if diffs:
                max_diff = max(max_diff, float(torch.stack(diffs).max()))
            if max_diff < tol:
                break
        if info is not None:
            info["log_scale"] = float(log_scale)
            info["gauges"] = gauges
        if not gauges_supplied:
            tn.gauge_simple_insert(gauges)
        return tn

    def gauge_simple_insert(self, gauges, smudge=0.0):
        """Absorb sqrt of each gauge into both tensors of its bond."""
        for ix, s in gauges.items():
            tids = tuple(self.ind_map.get(ix, ()))
            if len(tids) != 2:
                continue
            sq = torch.sqrt(s + smudge)
            for tid in tids:
                self.tensor_map[tid].multiply_index_diagonal_(ix, sq)
        return self

    def normalize_simple(self, gauges, inplace=True):
        """Normalize in the simple-gauge approximation: each site
        tensor (with gauges absorbed) to unit norm
        (reference ``normalize_simple`` tnag/core.py:1214)."""
        for site in self._sites:
            for t in self.select_tensors(self.site_tag(site), "any"):
                # absorb sqrt gauges, compute norm, unabsorb
                tg = t.copy()
                for ix in t.inds:
                    if ix in gauges:
                        tg.multiply_index_diagonal_(
                            ix, torch.sqrt(gauges[ix])
                        )
                nrm = float(tg.norm())
                if nrm > 0:
                    t.modify(apply=lambda d, nrm=nrm: d / nrm)
        return self

    def gate_simple(self, G, where, gauges, renorm=True,
                    smudge=1e-12, inplace=False, **gate_opts):
        """Apply a (1- or 2-site) gate in the simple-update gauge:
        absorb the environment gauges around ``where``, gate with
        ``reduce-split``, extract the updated central-bond gauge into
        ``gauges``, then unabsorb (reference ``gate_simple_``
        tnag/core.py). ``gauges`` is modified in place."""
        from ..core import tensor_compress_bond

        psi = self if inplace else self.copy()
        if not isinstance(where, (tuple, list)):
            where = (where,)
        if len(where) == 1:
            psi.gate_(G, where, contract=True, **gate_opts)
            return psi

        a, b = where
        (ta,) = psi.select_tensors(psi.site_tag(a), "any")
        (tb,) = psi.select_tensors(psi.site_tag(b), "any")
        central = list(bonds(ta, tb))
        central_ix = central[0] if central else None

        absorbed = []
        for t, coo in ((ta, a), (tb, b)):
            for ix in t.inds:
                if ix != central_ix and ix in gauges:
                    t.multiply_index_diagonal_(ix, gauges[ix] + smudge)
                    absorbed.append((coo, ix))
        if central_ix is not None and central_ix in gauges:
            s = gauges[central_ix]
            ta.multiply_index_diagonal_(central_ix, torch.sqrt(s))
            tb.multiply_index_diagonal_(central_ix, torch.sqrt(s))

        psi.gate_(G, where, contract="reduce-split", **gate_opts)

        (ta,) = psi.select_tensors(psi.site_tag(a), "any")
        (tb,) = psi.select_tensors(psi.site_tag(b), "any")
        central = list(bonds(ta, tb))
        if central:
            out = tensor_compress_bond(
                ta, tb, absorb=None,
                max_bond=gate_opts.get("max_bond"), cutoff=0.0,
            )
            if len(out) == 3:
                _, s, _ = out
                if renorm:
                    s = s / torch.linalg.norm(s)
                gauges[central[0]] = s

        for coo, ix in absorbed:
            (t,) = psi.select_tensors(psi.site_tag(coo), "any")
            if ix in t.inds and ix in gauges:
                t.multiply_index_diagonal_(ix, 1 / (gauges[ix] + smudge))
        return psi

    gate_simple_ = functools.partialmethod(gate_simple, inplace=True)

    # -- local expectations -----------------------------------------------------

    def local_expectation_exact(self, G, where, optimize="auto",
                                normalized=True, **contract_opts):
        """Exact local expectation by full contraction
        (reference tnag/core.py:2121)."""
        if not isinstance(where, (tuple, list)):
            where = (where,)
        ket = self.copy()
        bra = ket.H
        bra.mangle_inner_("*")
        kix = [self.site_ind(s) for s in where]
        bix = [rand_uuid() for _ in where]
        bra.reindex_(dict(zip(kix, bix)))
        GT = Tensor(
            _operator_like(G, ket).reshape(
                tuple(self.ind_size(ix) for ix in kix) * 2),
            inds=(*bix, *kix),
        )
        expec_tn = ket & bra & GT
        ev = expec_tn.contract(..., optimize=optimize, **contract_opts)
        if normalized:
            norm = (ket & bra.reindex(dict(zip(bix, kix)))).contract(
                ..., optimize=optimize, **contract_opts
            )
            ev = ev / norm
        return ev

    def local_expectation_cluster(
        self, G, where, normalized=True, max_distance=1, gauges=None,
        optimize="auto", smudge=1e-12, region=None, **contract_opts,
    ):
        """Cluster (simple-environment) local expectation
        (reference tnag/core.py:2425): contract only the neighbourhood
        of ``where`` (or the explicit site set ``region``), capping
        external bonds with the simple gauges."""
        if not isinstance(where, (tuple, list)):
            where = (where,)
        if region is None:
            region = self._site_neighborhood(where, max_distance)
        tags = tuple(self.site_tag(s) for s in region)
        ket = self.select(tags, which="any").copy()
        # absorb gauges on boundary bonds (bonds leaving the cluster
        # get the full gauge, internal ones sqrt on each... simple
        # update convention: dangling env bonds get full gauge)
        if gauges:
            inner_tids = set(
                itertools.chain.from_iterable(
                    ket.ind_map.get(ix, ()) for ix in ket.ind_map
                )
            )
            for ix in tuple(ket.ind_map):
                if ix not in gauges:
                    continue
                n_in = len(ket.ind_map[ix])
                full_n = len(self.ind_map[ix])
                if n_in == 2:
                    # internal bond: sqrt each side = full once
                    tids = tuple(ket.ind_map[ix])
                    sq = torch.sqrt(gauges[ix] + smudge)
                    for tid in tids:
                        ket.tensor_map[tid].multiply_index_diagonal_(
                            ix, sq
                        )
                elif n_in == 1 and full_n == 2:
                    # boundary bond: absorb the full gauge
                    (tid,) = ket.ind_map[ix]
                    ket.tensor_map[tid].multiply_index_diagonal_(
                        ix, gauges[ix] + smudge
                    )
        bra = ket.H
        bra.mangle_inner_("*")
        kix = [self.site_ind(s) for s in where]
        bix = [rand_uuid() for _ in where]
        bra.reindex_(dict(zip(kix, bix)))
        GT = Tensor(
            _operator_like(G, ket).reshape(
                tuple(self.ind_size(ix) for ix in kix) * 2),
            inds=(*bix, *kix),
        )
        # external (dangling) bonds of the cluster contract bra-ket
        expec_tn = ket & bra & GT
        ev = expec_tn.contract(..., optimize=optimize, **contract_opts)
        if normalized:
            norm_tn = ket & bra.reindex(dict(zip(bix, kix)))
            norm = norm_tn.contract(..., optimize=optimize,
                                    **contract_opts)
            ev = ev / norm
        return ev

    def _tid_to_site(self):
        m = {}
        for s in self._sites:
            for tid in self._get_tids_from_tags(self.site_tag(s), "any"):
                m[tid] = s
        return m

    def _gloop_site_regions(self, loops="gloops", max_size=None):
        """Site-sets of the generalized (or chordless) loops of the
        network."""
        from ..networking import gen_gloops, gen_sloops

        gen = gen_gloops if loops == "gloops" else gen_sloops
        t2s = self._tid_to_site()
        out = set()
        for gl in gen(self, max_size=max_size) if loops == "gloops" \
                else gen(self, max_loop_length=max_size):
            sites = frozenset(
                t2s[tid] for tid in gl if tid in t2s
            )
            if len(sites) > 1:
                out.add(sites)
        return out

    def local_expectation_gloop_expand(
        self, G, where, max_size=None, gauges=None, loops="gloops",
        **kwargs,
    ):
        """Loop-corrected local expectation (reference gloop/sloop
        expansions tnag/core.py:2682/:2875): combine gauge-capped
        cluster estimates over the base region and every loop-extended
        region, weighted by cluster-variation counting numbers."""
        from ..belief_propagation.extras import RegionGraph

        if not isinstance(where, (tuple, list)):
            where = (where,)
        if gauges is None:
            gauges = {}
            tn = self.gauge_all_simple(gauges=gauges)
        else:
            tn = self
        base = frozenset(where)
        regions = {base}
        for sites in tn._gloop_site_regions(loops, max_size):
            if sites & base:
                regions.add(base | sites)
        rg = RegionGraph(regions, autocomplete=True)
        ev = 0.0
        for region in rg.regions:
            c = rg.get_count(region)
            if c == 0:
                continue
            ev = ev + c * tn.local_expectation_cluster(
                G, where, region=region, gauges=gauges, **kwargs
            )
        return ev

    def norm_gloop_expand(self, max_size=None, gauges=None,
                          loops="gloops", smudge=1e-12, optimize="auto"):
        """Loop-corrected estimate of ``log <psi|psi>`` (reference
        ``norm_gloop_expand`` tnag/core.py:3025): ``sum_R c_R log Z_R``
        over single sites and loop regions with gauge-capped
        boundaries."""
        from ..belief_propagation.extras import RegionGraph

        log_scale = 0.0
        if gauges is None:
            info = {}
            gauges = {}
            tn = self.gauge_all_simple(info=info, gauges=gauges)
            log_scale = info["log_scale"]
        else:
            tn = self
        # base regions are the bonded site *pairs* — their single-site
        # intersections then carry the (negative) counting numbers that
        # divide out double-counted sites, exactly the Bethe / simple
        # gauge norm estimate; loop regions add the corrections
        t2s = tn._tid_to_site()
        regions = set()
        for ix, tids in tn.ind_map.items():
            sites = {t2s[t] for t in tids if t in t2s}
            if len(sites) == 2:
                regions.add(frozenset(sites))
        regions |= {frozenset((s,)) for s in tn._sites}
        regions |= tn._gloop_site_regions(loops, max_size)
        rg = RegionGraph(regions, autocomplete=True)
        logz = 0.0
        for region in rg.regions:
            c = rg.get_count(region)
            if c == 0:
                continue
            zr = tn._region_norm2(region, gauges, smudge=smudge,
                                  optimize=optimize)
            logz += c * math.log(abs(zr))
        return 0.5 * logz + log_scale

    def _region_norm2(self, region, gauges, smudge=1e-12,
                      optimize="auto"):
        """<psi|psi> restricted to a gauge-capped site region."""
        tags = tuple(self.site_tag(s) for s in region)
        ket = self.select(tags, which="any").copy()
        if gauges:
            for ix in tuple(ket.ind_map):
                if ix not in gauges:
                    continue
                n_in = len(ket.ind_map[ix])
                full_n = len(self.ind_map[ix])
                if n_in == 2:
                    sq = torch.sqrt(gauges[ix] + smudge)
                    for tid in tuple(ket.ind_map[ix]):
                        ket.tensor_map[tid].multiply_index_diagonal_(
                            ix, sq
                        )
                elif n_in == 1 and full_n == 2:
                    (tid,) = ket.ind_map[ix]
                    ket.tensor_map[tid].multiply_index_diagonal_(
                        ix, gauges[ix] + smudge
                    )
        bra = ket.H
        bra.mangle_inner_("*")
        return complex(
            (ket & bra).contract(..., optimize=optimize)
        ).real

    def local_expectation(self, G, where, method="cluster", **kwargs):
        if method == "exact":
            return self.local_expectation_exact(G, where, **kwargs)
        if method in ("gloop-expand", "sloop-expand"):
            return self.local_expectation_gloop_expand(
                G, where,
                loops="gloops" if method == "gloop-expand" else "sloops",
                **kwargs,
            )
        return self.local_expectation_cluster(G, where, **kwargs)

    def compute_local_expectation(self, terms, method="cluster",
                                  return_all=False, executor=None,
                                  **kwargs):
        """Sum of local expectations of ``terms`` {where: G}.

        With ``executor`` given (any ``concurrent.futures``-style
        executor, e.g. a ``ThreadPoolExecutor``) the per-term evaluations
        are submitted as independent futures — the reference's parallel
        local-expectation fan-out (tnag/core.py:4219-4256). Each term's
        contraction still runs on the tensors' device; the executor
        overlaps the host-side network selection and path work.
        """
        tn = self
        if method in (
            "cluster", "gloop-expand", "sloop-expand"
        ) and kwargs.get("gauges") is None:
            # derive converged simple gauges once: cluster estimates
            # with hard-cut boundaries are far less accurate,
            # especially for non-canonically-gauged states
            gauges = {}
            tn = self.gauge_all_simple(gauges=gauges)
            kwargs["gauges"] = gauges
        if executor is not None:
            futures = {
                where: executor.submit(
                    tn.local_expectation, G, where, method=method,
                    **kwargs,
                )
                for where, G in terms.items()
            }
            results = {w: f.result() for w, f in futures.items()}
        else:
            results = {}
            for where, G in terms.items():
                results[where] = tn.local_expectation(
                    G, where, method=method, **kwargs
                )
        if return_all:
            return results
        tot = sum(complex(v) for v in results.values())
        return tot.real if abs(tot.imag) < 1e-10 else tot

    compute_local_expectation_cluster = functools.partialmethod(
        compute_local_expectation, method="cluster")
    compute_local_expectation_exact = functools.partialmethod(
        compute_local_expectation, method="exact")


class TensorNetworkGenOperator(TensorNetworkGen):
    """Arbitrary-geometry TN operator with upper+lower indices
    (reference tnag/core.py:3690)."""

    _EXTRA_PROPS = (
        "_sites", "_site_tag_id", "_upper_ind_id", "_lower_ind_id"
    )

    @property
    def upper_ind_id(self):
        return self._upper_ind_id

    @upper_ind_id.setter
    def upper_ind_id(self, new_id):
        if new_id != self._upper_ind_id:
            self.reindex_upper_sites_(new_id)
            self._upper_ind_id = new_id

    @property
    def lower_ind_id(self):
        return self._lower_ind_id

    @lower_ind_id.setter
    def lower_ind_id(self, new_id):
        if new_id != self._lower_ind_id:
            self.reindex_lower_sites_(new_id)
            self._lower_ind_id = new_id

    def reindex_upper_sites(self, new_id, where=None, inplace=False):
        if where is None:
            where = self.gen_sites_present()
        tn = self if inplace else self.copy()
        tn.reindex_(
            {self.upper_ind(s): new_id.format(s) for s in where}
        )
        return tn

    def reindex_lower_sites(self, new_id, where=None, inplace=False):
        if where is None:
            where = self.gen_sites_present()
        tn = self if inplace else self.copy()
        tn.reindex_(
            {self.lower_ind(s): new_id.format(s) for s in where}
        )
        return tn

    reindex_upper_sites_ = functools.partialmethod(
        reindex_upper_sites, inplace=True
    )
    reindex_lower_sites_ = functools.partialmethod(
        reindex_lower_sites, inplace=True
    )

    def upper_ind(self, site):
        return self._upper_ind_id.format(site)

    def lower_ind(self, site):
        return self._lower_ind_id.format(site)

    def to_dense(self, *inds_seq, **contract_opts):
        if not inds_seq:
            inds_seq = (
                tuple(map(self.upper_ind, self._sites)),
                tuple(map(self.lower_ind, self._sites)),
            )
        # honor the groups exactly (reference delegates to the base
        # TensorNetwork.to_dense, tnag/core.py:3841)
        return TensorNetwork.to_dense(self, *inds_seq,
                                      **contract_opts)


# ---------------------------------------------------------------------------
# lattice bond bookkeeping + structural combinators
# (reference tnag/core.py:31 ``LatticeBondMap``, :118 ``tensor_network_align``,
#  :188 ``tensor_network_apply_op_vec``, :290 ``tensor_network_apply_op_op``,
#  :397 ``create_lazy_edge_map``, :449 ``tensor_network_ag_sum``)
# ---------------------------------------------------------------------------

class LatticeBondMap:
    """Helper for creating consistent lattice bond indices, with
    periodic-wrap awareness: coordinates just outside the lattice are
    interpreted as crossing a periodic boundary, keeping short periodic
    bonds distinct from in-lattice bonds."""

    def __init__(self, Lx, Ly=None, Lz=None):
        if Ly is None:
            self.shape = (Lx,)
        elif Lz is None:
            self.shape = (Lx, Ly)
        else:
            self.shape = (Lx, Ly, Lz)
        self.ndim = len(self.shape)
        self._ix = collections.defaultdict(rand_uuid)

    def wrap(self, *coos):
        wrapped = []
        for coo in coos:
            coo = tuple(coo)
            if len(coo) != self.ndim:
                raise ValueError("coordinate dimensionality mismatch")
            wrapped.append(
                tuple(x % L for x, L in zip(coo, self.shape))
            )
        if len(wrapped) == 1:
            return wrapped[0]
        return tuple(wrapped)

    def _key(self, cooa, coob):
        cooa, coob = tuple(cooa), tuple(coob)
        if len(cooa) != self.ndim or len(coob) != self.ndim:
            raise ValueError("coordinate dimensionality mismatch")
        periodic_axis = None
        cooa_wrapped = []
        for axis, (a, b, L) in enumerate(zip(cooa, coob, self.shape)):
            if not (0 <= a < L and 0 <= b < L):
                if periodic_axis is not None:
                    raise ValueError(
                        "only one periodic crossing supported"
                    )
                periodic_axis = axis
            cooa_wrapped.append(a % L)
        if periodic_axis is None:
            return frozenset((cooa, coob))
        key = list(cooa_wrapped)
        key[periodic_axis] = "PBC"
        return tuple(key)

    def __call__(self, cooa, coob, *, return_seen=False):
        key = self._key(cooa, coob)
        seen = key in self._ix
        bond = self._ix[key]
        if return_seen:
            return bond, seen
        return bond


def create_lazy_edge_map(tn, site_tags=None):
    """Which site tags are connected to which, computed from the index
    map in one pass (reference ``create_lazy_edge_map``
    tnag/core.py:397). Returns ``(edges, neighbors)``."""
    if site_tags is None:
        site_tags = tn.site_tags
    lookup = set(site_tags)
    edges = {}
    neighbors = {tag: [] for tag in site_tags if tag in tn.tag_map}
    for ix, tids in tn.ind_map.items():
        tags = {
            tag for tid in tids
            for tag in tn.tensor_map[tid].tags if tag in lookup
        }
        if len(tags) >= 2:
            i, j = tuple(sorted(tags))
            if (i, j) not in edges:
                edges[(i, j)] = [ix]
                neighbors[i].append(j)
                neighbors[j].append(i)
            else:
                edges[(i, j)].append(ix)
    return edges, neighbors


def tensor_network_ag_sum(tna, tnb, site_tags=None, negate=False,
                          compress=False, inplace=False,
                          **compress_opts):
    """Direct-sum two TNs with matching site structure (one tensor per
    site, single bond per edge) but possibly different bond names
    (reference ``tensor_network_ag_sum`` tnag/core.py:449)."""
    from ..core import tensor_direct_product

    tna = tna if inplace else tna.copy()
    edges_a, neighbors_a = create_lazy_edge_map(tna, site_tags)
    edges_b, _ = create_lazy_edge_map(tnb, site_tags)

    reindex_map = {}
    for (si, sj), inds in edges_a.items():
        (ixa,) = inds
        (ixb,) = edges_b.pop((si, sj))
        reindex_map[ixb] = ixa
    if edges_b:
        raise ValueError("not all edges matched")

    for si in neighbors_a:
        (ta,) = tna.select_tensors(si, "any")
        (tb,) = tnb.select_tensors(si, "any")
        tb = tb.reindex(reindex_map)
        sum_inds = [ix for ix in tb.inds if ix not in reindex_map.values()]
        if negate:
            tb.modify(apply=lambda x: -x)
            negate = False
        tab = tensor_direct_product(ta, tb, sum_inds)
        ta.modify(data=tab.data)

    if compress:
        for si, sj in edges_a:
            (ta,) = tna.select_tensors(si, "any")
            (tb,) = tna.select_tensors(sj, "any")
            from ..core import tensor_compress_bond
            tensor_compress_bond(ta, tb, **compress_opts)
    return tna


def tensor_network_align(*tns, ind_ids=None, trace=False,
                         inplace=False):
    """Align vector/operator TNs in a stack so neighbouring layers
    share indices (reference ``tensor_network_align``
    tnag/core.py:118)."""
    if not inplace:
        tns = [tn.copy() for tn in tns]
    else:
        tns = list(tns)
    n = len(tns)
    if ind_ids is None:
        first = tns[0]
        base = (first.site_ind_id if hasattr(first, "site_ind_id")
                else first.lower_ind_id)
        ind_ids = [base] + [
            f"__align{i}_" + "{}__" for i in range(n - 2)
        ]
    else:
        ind_ids = list(ind_ids)

    for i, tn in enumerate(tns):
        if hasattr(tn, "site_ind_id"):
            if i == 0:
                tn.site_ind_id = ind_ids[0]
            elif i == n - 1:
                tn.site_ind_id = ind_ids[i - 1]
            else:
                raise ValueError(
                    "a TN 'vector' can only be first or last"
                )
        elif hasattr(tn, "upper_ind_id"):
            if i != 0:
                tn.upper_ind_id = ind_ids[i - 1]
            if i != n - 1:
                tn.lower_ind_id = ind_ids[i]
        else:
            raise ValueError("can only align vectors and operators")
    if trace:
        tns[-1].lower_ind_id = tns[0].upper_ind_id
    return tns


def tensor_network_apply_op_vec(A, x, which_A="lower", contract=False,
                                fuse_multibonds=True, compress=False,
                                inplace=False, inplace_A=False,
                                **compress_opts):
    """Lazily apply operator TN ``A`` to vector TN ``x`` — pair up the
    site tensors then optionally contract sites / fuse multibonds /
    compress (reference ``tensor_network_apply_op_vec``
    tnag/core.py:188)."""
    x = x if inplace else x.copy()
    A = A if inplace_A else A.copy()

    inner_ind_id = rand_uuid() + "{}"
    if which_A == "lower":
        A.lower_ind_id = inner_ind_id
        A.upper_ind_id = x.site_ind_id
    elif which_A == "upper":
        A.upper_ind_id = inner_ind_id
        A.lower_ind_id = x.site_ind_id
    else:
        raise ValueError(f"invalid which_A: {which_A}")

    sites_present = tuple(A.gen_sites_present())
    x.reindex_sites_(inner_ind_id, where=sites_present)
    x.add_tensor_network(A, virtual=True, check_collisions=True)

    if contract:
        for site in sites_present:
            x.contract_tags_(x.site_tag(site), which="any")
        if fuse_multibonds:
            x.fuse_multibonds_()
    if compress:
        for sa, sb in x.gen_bonds():
            (ta,) = x.select_tensors(x.site_tag(sa), "any")
            (tb,) = x.select_tensors(x.site_tag(sb), "any")
            from ..core import tensor_compress_bond
            tensor_compress_bond(ta, tb, **compress_opts)
    return x


def tensor_network_apply_op_op(A, B, which_A="lower", which_B="upper",
                               contract=False, fuse_multibonds=True,
                               compress=False, inplace=False,
                               inplace_A=False, **compress_opts):
    """Lazily apply operator TN ``A`` to operator TN ``B`` (reference
    ``tensor_network_apply_op_op`` tnag/core.py:290)."""
    B = B if inplace else B.copy()
    A = A if inplace_A else A.copy()

    inner_ind_id = rand_uuid() + "{}"
    if (which_A, which_B) == ("lower", "upper"):
        A.lower_ind_id = inner_ind_id
        A.upper_ind_id = B.upper_ind_id
        B.reindex_upper_sites_(inner_ind_id)
    elif (which_A, which_B) == ("lower", "lower"):
        A.lower_ind_id = inner_ind_id
        A.upper_ind_id = B.lower_ind_id
        B.reindex_lower_sites_(inner_ind_id)
    elif (which_A, which_B) == ("upper", "upper"):
        A.upper_ind_id = inner_ind_id
        A.lower_ind_id = B.upper_ind_id
        B.reindex_upper_sites_(inner_ind_id)
    elif (which_A, which_B) == ("upper", "lower"):
        A.upper_ind_id = inner_ind_id
        A.lower_ind_id = B.lower_ind_id
        B.reindex_lower_sites_(inner_ind_id)
    else:
        raise ValueError("invalid which_A/which_B combination")

    B.add_tensor_network(A, virtual=True, check_collisions=True)

    if contract:
        for site in B.gen_sites_present():
            B.contract_tags_(B.site_tag(site), which="any")
        if fuse_multibonds:
            B.fuse_multibonds_()
    if compress:
        for sa, sb in B.gen_bonds():
            (ta,) = B.select_tensors(B.site_tag(sa), "any")
            (tb,) = B.select_tensors(B.site_tag(sb), "any")
            from ..core import tensor_compress_bond
            tensor_compress_bond(ta, tb, **compress_opts)
    return B


def tensor_network_ag_gate(self, G, where, contract="reduce-split",
                           tags=None, inplace=False, **opts):
    """Module-level alias of ``TensorNetworkGenVector.gate`` (reference
    ``tensor_network_ag_gate`` tnag/core.py)."""
    return TensorNetworkGenVector.gate(
        self, G, where, contract=contract, tags=tags, inplace=inplace,
        **opts,
    )


def tensor_network_ag_gate_simple(self, G, where, gauges,
                                  renorm=True, **gate_opts):
    """Apply a gate in the simple-update gauge: insert the bond gauges
    around the gated sites, gate with ``reduce-split``, then extract
    the updated gauges (reference ``gate_simple_``)."""
    return TensorNetworkGenVector.gate_simple_(
        self, G, where, gauges, renorm=renorm, **gate_opts
    )


# ---------------------------------------------------------------------------
# TensorNetworkGen(Vector) method parity layer (reference tnag/core.py)
# ---------------------------------------------------------------------------

def _agv_site_inds_present(self):
    return tuple(
        self.site_ind(s) for s in self.gen_sites_present()
    )


def _agv_gen_inds_from_coos(self, coos):
    return tuple(self.site_ind(c) for c in coos)


def _agv_reindex_all(self, new_id, inplace=False):
    """Reindex every site index to a new format id (reference
    ``reindex_all``)."""
    tn = self if inplace else self.copy()
    tn.reindex_sites_(new_id)
    tn._site_ind_id = new_id
    return tn


def _agv_reset_cached_properties(self):
    return self


def _agv_get_cluster(self, sites, max_distance=1, virtual=False):
    """The local cluster of tensors around ``sites`` (reference
    ``get_cluster``)."""
    region = self._site_neighborhood(
        tuple(sites), max_distance=max_distance
    )
    ts = []
    for s in region:
        ts.extend(self.select_tensors(self.site_tag(s), "any"))
    return TensorNetwork(ts, virtual=virtual)


def _agv_make_reduced_density_matrix(self, where, max_distance=None,
                                     **kwargs):
    """The (lazy) reduced density operator network of ``where``
    (reference ``make_reduced_density_matrix``)."""
    if not isinstance(where, (tuple, list)):
        where = (where,)
    ket = self.copy()
    bra = ket.conj()
    bix = {self.site_ind(s): f"__rho_b{s}__" for s in where}
    bra.reindex_(bix)
    bra.mangle_inner_("*")
    return TensorNetwork((ket, bra), virtual=True)


def _agv_partial_trace_exact(self, where, optimize="auto",
                             **contract_opts):
    """Dense reduced density matrix by exact contraction (reference
    ``partial_trace_exact``)."""
    if not isinstance(where, (tuple, list)):
        where = (where,)
    rho_tn = _agv_make_reduced_density_matrix(self, where)
    kix = [self.site_ind(s) for s in where]
    bix = [f"__rho_b{s}__" for s in where]
    t = rho_tn.contract(
        ..., output_inds=(*kix, *bix), preserve_tensor=True,
        optimize=optimize, **contract_opts,
    )
    d = int(np.prod([self.ind_size(ix) for ix in kix]))
    rho = t.data.reshape(d, d)
    tr = torch.trace(rho)
    return rho / tr


def _agv_partial_trace_cluster(self, where, max_distance=1,
                               gauges=None, **contract_opts):
    """Reduced density matrix from the local cluster with
    simple-gauge boundary capping (reference
    ``partial_trace_cluster``)."""
    if not isinstance(where, (tuple, list)):
        where = (where,)
    cluster = _agv_get_cluster(self, where,
                               max_distance=max_distance)
    cluster = cluster.copy()
    if gauges:
        # absorb sqrt gauges on boundary bonds
        for ix, s in gauges.items():
            tids = tuple(cluster.ind_map.get(ix, ()))
            g = torch.sqrt(s)
            for tid in tids:
                cluster.tensor_map[tid].multiply_index_diagonal_(
                    ix, g
                )
    ket_inds = [self.site_ind(s) for s in where]
    bra = cluster.conj()
    bix = {ix: ix + "__b__" for ix in ket_inds}
    bra.reindex_(bix)
    bra.mangle_inner_("*")
    rho_tn = TensorNetwork((cluster, bra), virtual=True)
    t = rho_tn.contract(
        ..., output_inds=(*ket_inds, *bix.values()),
        preserve_tensor=True, **contract_opts,
    )
    d = int(np.prod([self.ind_size(ix) for ix in ket_inds]))
    rho = t.data.reshape(d, d)
    return rho / torch.trace(rho)


def _agv_partial_trace(self, where, method="exact", **kwargs):
    if method == "exact":
        return _agv_partial_trace_exact(self, where, **kwargs)
    return _agv_partial_trace_cluster(self, where, **kwargs)


def _agv_sample_configuration_cluster(self, seed=None, max_distance=1,
                                      gauges=None, **kwargs):
    """Sample a basis configuration site by site from cluster
    marginals (reference ``sample_configuration_cluster``)."""
    rng = np.random.default_rng(seed)
    psi = self.copy()
    config = {}
    omega = 1.0
    for s in psi.sites:
        rho = _agv_partial_trace_cluster(
            psi, (s,), max_distance=max_distance, gauges=gauges,
            **kwargs,
        )
        p = torch.diagonal(rho).real.clamp(min=0.0)
        p = to_host(p / p.sum()).astype(float)
        v = int(rng.choice(p.size, p=p))
        config[s] = v
        omega *= float(p[v])
        psi.isel_({psi.site_ind(s): v})
    return config, omega


def _agv_gate_with_op_lazy(self, A, inplace=False, **kwargs):
    """Lazily apply an operator TN (reference
    ``gate_with_op_lazy``)."""
    return tensor_network_apply_op_vec(
        A, self, inplace=inplace, **kwargs
    )


def _agv_gate_fit_local_(self, G, where, max_distance=1, **fit_opts):
    """Apply a gate by fitting the local cluster (reference
    ``gate_fit_local_``): here falls back to reduce-split gating,
    which is exact up to the same bond truncation."""
    return self.gate_(G, where, contract="reduce-split", **fit_opts)


def _wire_agv_parity():
    V = TensorNetworkGenVector
    V.site_inds_present = property(_agv_site_inds_present)
    V.gen_inds_from_coos = _agv_gen_inds_from_coos
    V.reindex_all = _agv_reindex_all
    V.reindex_all_ = functools.partialmethod(_agv_reindex_all,
                                             inplace=True)
    V.reset_cached_properties = _agv_reset_cached_properties
    TensorNetworkGen.reset_cached_properties = \
        _agv_reset_cached_properties
    V.get_cluster = _agv_get_cluster
    V.make_reduced_density_matrix = _agv_make_reduced_density_matrix
    V.partial_trace_exact = _agv_partial_trace_exact
    V.partial_trace_cluster = _agv_partial_trace_cluster
    V.partial_trace = _agv_partial_trace
    V.sample_configuration_cluster = _agv_sample_configuration_cluster
    V.gate_with_op_lazy = _agv_gate_with_op_lazy
    V.gate_with_op_lazy_ = functools.partialmethod(
        _agv_gate_with_op_lazy, inplace=True
    )
    V.gate_fit_local_ = _agv_gate_fit_local_
    # expectation-variant aliases over the existing dispatcher
    V.local_expectation_simple = V.local_expectation_cluster
    V.local_expectation_sloop_expand = \
        V.local_expectation_gloop_expand
    V.compute_local_expectation_simple = functools.partialmethod(
        V.compute_local_expectation, method="cluster"
    )
    # quimb_tpu passes method="gloop" here, which its dispatcher reads as
    # "cluster": the expansions name their own methods
    V.compute_local_expectation_gloop_expand = \
        functools.partialmethod(
            V.compute_local_expectation, method="gloop-expand"
        )
    V.compute_local_expectation_sloop_expand = \
        functools.partialmethod(
            V.compute_local_expectation, method="sloop-expand"
        )
    V.compute_local_expectation_tn = functools.partialmethod(
        V.compute_local_expectation, method="exact"
    )

    def compute_local_expectation_rehearse(self, terms, **kwargs):
        """Report the clusters/contractions that a local-expectation
        computation would perform, without contracting (reference
        ``compute_local_expectation_rehearse``)."""
        out = {}
        for where in terms:
            w = where if isinstance(where, (tuple, list)) else \
                (where,)
            cluster = _agv_get_cluster(self, tuple(w))
            out[where] = {
                "num_tensors": cluster.num_tensors,
                "inds": tuple(cluster.all_inds()),
            }
        return out

    V.compute_local_expectation_rehearse = \
        compute_local_expectation_rehearse


_wire_agv_parity()


# ---------------------------------------------------------------------------
# generic-geometry method parity layer (reference tnag/core.py:860-1500)
# ---------------------------------------------------------------------------

def _ag_tid_to_site_map(self):
    """Map each tensor id to the site it represents (single tensor per
    site assumed, extra tensors skipped)."""
    tid2site = {}
    for site in self.gen_sites_present():
        tids = self.tag_map.get(self.site_tag(site), ())
        if len(tids) == 1:
            tid2site[next(iter(tids))] = site
    return tid2site


def _ag_has_site(self, site):
    try:
        return site in set(self._sites)
    except TypeError:
        return False


def _ag_gen_site_coos(self):
    return self._sites


def _ag_retag_sites(self, new_id, where=None, inplace=False):
    """Change the site tags to follow format ``new_id`` (without
    changing ``site_tag_id``; reference ``retag_sites``
    tnag/core.py:917)."""
    if where is None:
        where = self.gen_sites_present()
    return self.retag(
        {self.site_tag(x): new_id.format(x) for x in where},
        inplace=inplace,
    )


def _ag_retag_all(self, new_id, inplace=False):
    """Retag all sites and update ``site_tag_id`` (reference
    ``retag_all`` tnag/core.py:958)."""
    tn = self if inplace else self.copy()
    _ag_retag_sites(tn, new_id, inplace=True)
    tn._site_tag_id = new_id
    return tn


def _ag_filter_valid_site_tags(self, tags):
    """The subset of ``tags`` that are site tags (reference
    ``filter_valid_site_tags`` tnag/core.py:972)."""
    valid = set(self.site_tags)
    return oset(sorted(valid.intersection(tags), key=str))


def _ag_gen_tags_from_coos(self, coos):
    return map(self.site_tag, coos)


def _ag_select_sites(self, sites, virtual=True, with_exponent=False):
    """Sub-network of just the given sites (reference ``select_sites``
    tnag/core.py:1012)."""
    tags = tuple(map(self.site_tag, sites))
    return self.select(tags, which="any", virtual=virtual)


def _ag_gen_bond_coos(self):
    """Pairs of sites connected by at least one bond (reference
    ``gen_bond_coos`` tnag/core.py:1074)."""
    return self.gen_bonds()


def _ag_get_site_neighbor_map(self):
    """Map each present site to its neighbouring sites (reference
    ``get_site_neighbor_map`` tnag/core.py:1088)."""
    return {
        site: tuple(self.neighbors(site))
        for site in self.gen_sites_present()
    }


def _ag_gen_gloops_sites(self, max_size=None, sites=None,
                         grow_from="all", num_joins=1, join_overlap=2):
    """Generalized loops as tuples of *sites* rather than tids
    (reference ``gen_gloops_sites`` tnag/core.py:1098)."""
    from ..networking import gen_gloops

    tid2site = _ag_tid_to_site_map(self)
    want = set(sites) if sites is not None else None
    for gloop in gen_gloops(self, max_size=max_size):
        sl = tuple(tid2site.get(tid) for tid in gloop)
        if any(s is None for s in sl):
            continue
        if want is not None:
            if grow_from.startswith("all"):
                if not want.issubset(sl):
                    continue
            elif not (want & set(sl)):
                continue
        yield sl


def _ag_get_local_loops(self, gen, *, tids=None, where=None,
                        loops=None, grow_from="all", num_joins=1,
                        intersect=False, strict_size=False, info=None):
    from ..networking import gen_gloops, gen_sloops  # noqa: F401

    tid2site = _ag_tid_to_site_map(self)
    if loops is None or isinstance(loops, int):
        max_size = loops if isinstance(loops, int) else None
        raw = (
            tuple(tid2site.get(tid) for tid in lp)
            for lp in gen(self, max_size)
        )
        loops = tuple(
            lp for lp in raw if not any(s is None for s in lp)
        )
    else:
        loops = tuple(tuple(lp) for lp in loops)
    if where is not None:
        w = set(where)
        if grow_from.startswith("all"):
            loops = tuple(
                lp for lp in loops if w.issubset(lp)
            )
        else:
            loops = tuple(lp for lp in loops if w & set(lp))
    if isinstance(strict_size, int) and not isinstance(
        strict_size, bool
    ):
        loops = tuple(lp for lp in loops if len(lp) <= strict_size)
    return loops


def _ag_get_local_gloops(self, *, tids=None, where=None, gloops=None,
                         grow_from="all", num_joins=1,
                         strict_size=False, info=None):
    """The generalized loops relevant to the sites ``where``
    (reference ``get_local_gloops`` tnag/core.py:1394)."""
    from ..networking import gen_gloops

    return _ag_get_local_loops(
        self, lambda tn, ms: gen_gloops(tn, max_size=ms),
        tids=tids, where=where, loops=gloops, grow_from=grow_from,
        num_joins=num_joins, strict_size=strict_size, info=info,
    )


def _ag_get_local_sloops(self, *, where=None, sloops=None,
                         num_joins=1, intersect=False,
                         grow_from="all", strict_size=False,
                         info=None):
    """The simple (chordless) loops relevant to the sites ``where``
    (reference ``get_local_sloops`` tnag/core.py:1260)."""
    from ..networking import gen_sloops

    return _ag_get_local_loops(
        self, lambda tn, ms: gen_sloops(tn, max_loop_length=ms),
        where=where, loops=sloops, grow_from=grow_from,
        num_joins=num_joins, intersect=intersect,
        strict_size=strict_size, info=info,
    )


def _ag_align(self, *args, inplace=False, **kwargs):
    """Align this TN with others for contraction (reference ``align``
    tnag/core.py:1167)."""
    return tensor_network_align(self, *args, **kwargs)[0]


def _ag_flatten(self, fuse_multibonds=True, inplace=False,
                **contract_opts):
    """Contract all tensors at each site to one tensor per site
    (reference ``flatten`` tnag/core.py:1184)."""
    tn = self if inplace else self.copy()
    for site in tn.gen_sites_present():
        tag = tn.site_tag(site)
        if len(tn.tag_map.get(tag, ())) > 1:
            tn.contract_tags_(tag, which="any", **contract_opts)
    if fuse_multibonds:
        tn.fuse_multibonds_()
    return tn


def _wire_ag_parity():
    G = TensorNetworkGen
    G.gen_site_coos = _ag_gen_site_coos
    G.has_site = _ag_has_site
    G.retag_sites = _ag_retag_sites
    G.site_tags_present = property(lambda self: tuple(
        map(self.site_tag, self.gen_sites_present())))
    G.retag_all = _ag_retag_all
    G.retag_all_ = functools.partialmethod(_ag_retag_all,
                                           inplace=True)
    G.filter_valid_site_tags = _ag_filter_valid_site_tags
    G.gen_tags_from_coos = _ag_gen_tags_from_coos
    G.select_sites = _ag_select_sites
    G.gen_bond_coos = _ag_gen_bond_coos
    G.get_site_neighbor_map = _ag_get_site_neighbor_map
    G.gen_gloops_sites = _ag_gen_gloops_sites
    G.get_local_gloops = _ag_get_local_gloops
    G.get_local_sloops = _ag_get_local_sloops
    G.align = _ag_align
    G.align_ = functools.partialmethod(_ag_align, inplace=True)
    G.flatten = _ag_flatten
    G.flatten_ = functools.partialmethod(_ag_flatten, inplace=True)
    # settable site_tag_id, retagging on assignment
    def _set_site_tag_id(self, new_id):
        if self._site_tag_id != new_id:
            _ag_retag_sites(self, new_id, inplace=True)
            self._site_tag_id = new_id
    G.site_tag_id = property(
        lambda self: self._site_tag_id, _set_site_tag_id
    )
    # normalize_simple is geometry-generic: share the vector impl
    G.normalize_simple = TensorNetworkGenVector.normalize_simple


_wire_ag_parity()


# ---------------------------------------------------------------------------
# TensorNetworkGenOperator method parity layer (reference
# tnag/core.py:3690-4200)
# ---------------------------------------------------------------------------

def _conj_arr(G):
    return G.conj() if hasattr(G, "conj") else np.conj(G)


def _ago_gate(self, G, where, which=None, contract="reduce-split",
              tags=None, inplace=False, **opts):
    """Gate an operator TN at ``where`` on its upper, lower or both
    ('sandwich', :math:`X \\to G X G^\\dagger`) physical indices
    (reference ``tensor_network_ag_gate`` tnag/core.py:518)."""
    from ..gating import tensor_network_gate_inds

    tn = self if inplace else self.copy()
    if tn.has_site(where):
        where = (where,)
    else:
        where = tuple(where)
    if which is None:
        which = "sandwich"
    if which in ("sandwich", "both"):
        _ago_gate(tn, G, where, which="upper", contract=contract,
                  tags=tags, inplace=True, **opts)
        # lower indices transform with conj(G):
        # (G X Gd)_{ul} = G_{uu'} X_{u'l'} conj(G)_{ll'}
        _ago_gate(tn, _conj_arr(G), where, which="lower",
                  contract=contract, tags=tags, inplace=True, **opts)
        return tn
    if which == "upper":
        inds = tuple(tn.upper_ind(s) for s in where)
    elif which == "lower":
        inds = tuple(tn.lower_ind(s) for s in where)
    else:
        raise ValueError(f"bad which: {which}")
    if len(inds) == 1:
        contract = True
    tensor_network_gate_inds(
        tn, G, inds, contract=contract, tags=tags, inplace=True,
        **opts,
    )
    return tn


def _ago_apply(self, other, compress=False, contract=True,
               inplace=False, **compress_opts):
    """Act with this operator TN on a vector or operator TN,
    returning a TN with the outer structure of ``other`` (reference
    ``apply`` tnag/core.py:4043)."""
    if hasattr(other, "upper_ind_id"):
        return tensor_network_apply_op_op(
            self, other, contract=contract, compress=compress,
            inplace_A=inplace, **compress_opts,
        )
    return tensor_network_apply_op_vec(
        self, other, contract=contract, compress=compress,
        inplace_A=inplace, **compress_opts,
    )


def _ago_gate_upper_with_op_lazy(self, A, transpose=False,
                                 inplace=False):
    """Lazily pre-apply operator TN ``A``: ``B -> A B`` (or ``A^T B``;
    reference ``gate_upper_with_op_lazy`` tnag/core.py:3902)."""
    return tensor_network_apply_op_op(
        A, self, which_A="upper" if transpose else "lower",
        which_B="upper", contract=False, inplace=inplace,
    )


def _ago_gate_lower_with_op_lazy(self, A, transpose=False,
                                 inplace=False):
    """Lazily post-apply operator TN ``A``: ``B -> B A`` (or
    ``B A^T``; reference ``gate_lower_with_op_lazy``
    tnag/core.py:3956)."""
    return tensor_network_apply_op_op(
        A, self, which_A="lower" if transpose else "upper",
        which_B="lower", contract=False, inplace=inplace,
    )


def _ago_gate_sandwich_with_op_lazy(self, A, inplace=False):
    """Lazily conjugate by operator TN ``A``:
    ``B -> A B A^\\dagger`` (reference ``gate_sandwich_with_op_lazy``
    tnag/core.py:4011)."""
    B = self if inplace else self.copy()
    _ago_gate_upper_with_op_lazy(B, A, inplace=True)
    _ago_gate_lower_with_op_lazy(B, A.conj(), transpose=True,
                                 inplace=True)
    return B


def _ago_partial_transpose(self, sysa, inplace=False):
    """Swap upper and lower physical indices on the sites ``sysa``
    (reference ``partial_transpose`` tnag/core.py:4154)."""
    tn = self if inplace else self.copy()
    if tn.has_site(sysa):
        sysa = (sysa,)
    else:
        sysa = tuple(sysa)
    tmp = {s: rand_uuid() for s in sysa}
    tn.reindex_({tn.upper_ind(s): tmp[s] for s in sysa})
    tn.reindex_({tn.lower_ind(s): tn.upper_ind(s) for s in sysa})
    tn.reindex_({tmp[s]: tn.lower_ind(s) for s in sysa})
    return tn


def _ago_phys_dim(self, site=None, which="upper"):
    if site is None:
        site = next(iter(self.gen_sites_present()))
    ix = self.upper_ind(site) if which == "upper" else \
        self.lower_ind(site)
    return self.ind_size(ix)


def _wire_ago_parity():
    O = TensorNetworkGenOperator
    O.upper_inds = property(lambda self: tuple(
        map(self.upper_ind, self._sites)))
    O.upper_inds_present = property(lambda self: tuple(
        self.upper_ind(s) for s in self.gen_sites_present()
        if self.upper_ind(s) in self.ind_map))
    O.lower_inds = property(lambda self: tuple(
        map(self.lower_ind, self._sites)))
    O.lower_inds_present = property(lambda self: tuple(
        self.lower_ind(s) for s in self.gen_sites_present()
        if self.lower_ind(s) in self.ind_map))
    O.phys_dim = _ago_phys_dim
    O.gate = _ago_gate
    O.gate_ = functools.partialmethod(_ago_gate, inplace=True)
    O.gate_sandwich = functools.partialmethod(_ago_gate,
                                              which="sandwich")
    O.gate_sandwich_ = functools.partialmethod(
        _ago_gate, which="sandwich", inplace=True)
    O.gate_upper = functools.partialmethod(_ago_gate, which="upper")
    O.gate_upper_ = functools.partialmethod(_ago_gate, which="upper",
                                            inplace=True)
    O.gate_lower = functools.partialmethod(_ago_gate, which="lower")
    O.gate_lower_ = functools.partialmethod(_ago_gate, which="lower",
                                            inplace=True)
    # the simple-gauge gate implementation is index-agnostic (it works
    # through ``gate_``): share the vector implementation
    O.gate_simple = TensorNetworkGenVector.gate_simple
    O.gate_simple_ = functools.partialmethod(O.gate_simple,
                                             inplace=True)
    O.gate_upper_with_op_lazy = _ago_gate_upper_with_op_lazy
    O.gate_upper_with_op_lazy_ = functools.partialmethod(
        _ago_gate_upper_with_op_lazy, inplace=True)
    O.gate_lower_with_op_lazy = _ago_gate_lower_with_op_lazy
    O.gate_lower_with_op_lazy_ = functools.partialmethod(
        _ago_gate_lower_with_op_lazy, inplace=True)
    O.gate_sandwich_with_op_lazy = _ago_gate_sandwich_with_op_lazy
    O.gate_sandwich_with_op_lazy_ = functools.partialmethod(
        _ago_gate_sandwich_with_op_lazy, inplace=True)
    O.apply = _ago_apply
    O.apply_ = functools.partialmethod(_ago_apply, inplace=True)
    O.dot = _ago_apply
    O.partial_transpose = _ago_partial_transpose
    O.partial_transpose_ = functools.partialmethod(
        _ago_partial_transpose, inplace=True)


_wire_ago_parity()
