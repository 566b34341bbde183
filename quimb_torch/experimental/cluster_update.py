"""Cluster update: a gate, then a bond compression fitted against a local
cluster's environment instead of the Vidal gauges alone.

Port of quimb_tpu's ``experimental/cluster_update.py`` (reference
``quimb/experimental/cluster_update/cxu.py``). The environment
``E[kl, kr, bl, br]`` of the expanded bond comes from the norm network of
the distance-``r`` cluster around the gated pair (its boundary bonds
weighted by the simple gauges); projectors ``Pl @ Pr`` are fitted to it
by alternating least squares (reference ``compute_bondenv_projectors``
decomp.py:3202) and inserted on the bond. As in quimb_tpu, each ALS
iteration reads its cost to the host, and each gate reads the two site
tensors' norms: :data:`HOST_READS` counts both.
"""

import collections

import torch

from ..ops import decomp
from ..tensor.core import (
    Tensor,
    TensorNetwork,
    bonds,
    tensor_compress_bond,
    tensor_contract,
)
from ..tensor.tnag.tebd import SimpleUpdateGen

__all__ = ["fit_bondenv_projectors", "ClusterUpdateGen"]

# host reads by kind: "als cost" (one per ALS iteration) and "site norm"
# (two per gate)
HOST_READS = collections.Counter()


def fit_bondenv_projectors(E, max_bond, cutoff=0.0, max_iterations=60,
                           tol=1e-10, enforce_pos=True, pos_smudge=1e-10,
                           Pl0=None, Pr0=None):
    """Fit ``Pl (D, m)`` and ``Pr (m, D)`` minimizing the
    environment-weighted distance ``(x - I)^H E (x - I)``, ``x = Pl @ Pr``.

    ``E`` has axes (ket-left, ket-right, bra-left, bra-right). Returns
    ``(Pl, s, Pr)`` with ``sqrt(s)`` absorbed on both sides. ``Pl0`` and
    ``Pr0`` seed the alternation (the ALS objective has local optima)."""
    D = E.shape[0]
    m = min(max_bond, D)
    # hermitize, and clip to positive semi-definite over (ket, bra)
    Em = E.reshape(D * D, D * D)
    Em = (Em + Em.conj().T) / 2
    if enforce_pos:
        w, V = torch.linalg.eigh(Em)
        w = torch.clamp(w, min=pos_smudge * torch.max(torch.abs(w)))
        Em = (V * w) @ V.conj().T
    E = Em.reshape(D, D, D, D)

    if Pl0 is not None and Pr0 is not None and Pl0.shape[1] == m:
        Pl, Pr = Pl0, Pr0
    else:
        # from the bra-traced environment
        M = torch.einsum("abcc->ab", E)
        U, s0, VH = decomp.svd_truncated(M, max_bond=m, cutoff=0.0,
                                         absorb=None)
        sq = torch.sqrt(torch.clamp(s0, min=1e-12))
        Pl, Pr = U * sq, sq[:, None] * VH

    x0 = torch.eye(D, dtype=E.dtype, device=E.device)

    def cost(Pl, Pr):
        x = Pl @ Pr
        xEx = torch.einsum("abcd,cd,ab->", E, x.conj(), x)
        xEx0 = torch.einsum("abcd,cd,ab->", E, x.conj(), x0)
        HOST_READS["als cost"] += 1
        return float((xEx - 2 * xEx0.real).real)

    def solve(N, bv, n):
        Nm = N.reshape(n, n)
        Nm = Nm + 1e-12 * torch.trace(Nm).real / n * torch.eye(
            n, dtype=Nm.dtype, device=Nm.device)
        return torch.linalg.solve(Nm, bv.reshape(n))

    prev = None
    for _ in range(max_iterations):
        N = torch.einsum("abcd,nd,mb->cnam", E, Pr.conj(), Pr)
        bv = torch.einsum("abcd,nd,ab->cn", E, Pr.conj(), x0)
        Pl = solve(N, bv, D * m).reshape(D, m)
        N = torch.einsum("abcd,cn,am->ndmb", E, Pl.conj(), Pl)
        bv = torch.einsum("abcd,cn,ab->nd", E, Pl.conj(), x0)
        Pr = solve(N, bv, m * D).reshape(m, D)
        c = cost(Pl, Pr)
        if prev is not None and abs(c - prev) < tol * max(abs(c), 1e-30):
            break
        prev = c

    # re-split, to share the weight evenly (and apply any cutoff)
    U, s, VH = decomp.svd_truncated(Pl @ Pr, max_bond=m, cutoff=cutoff,
                                    absorb=None)
    sq = torch.sqrt(s)
    return U * sq, s, sq[:, None] * VH


class ClusterUpdateGen(SimpleUpdateGen):
    """Simple update whose bond truncation after each gate is fitted
    against the distance-``cluster_distance`` cluster environment
    (reference ``ClusterUpdateGen`` cxu.py:494)."""

    def __init__(self, psi0, ham, *, cluster_distance=1, fit_iterations=30,
                 fit_tol=1e-10, **kwargs):
        super().__init__(psi0, ham, **kwargs)
        self.cluster_distance = cluster_distance
        self.fit_iterations = fit_iterations
        self.fit_tol = fit_tol
        # the energy estimator must look at least as far as the update
        self.compute_energy_opts.setdefault("max_distance",
                                            cluster_distance + 1)

    def _cluster_sites(self, a, b):
        """The sites within graph distance ``cluster_distance`` of the
        pair."""
        psi = self.state
        frontier = seen = {a, b}
        for _ in range(self.cluster_distance):
            nxt = set()
            for site in frontier:
                t = self._site_tensor(site)
                for other in psi._sites:
                    if other not in seen and bonds(t,
                                                   self._site_tensor(other)):
                        nxt.add(other)
            seen = seen | nxt
            frontier = nxt
        return seen

    def gate(self, U, where):
        psi = self.state
        a, b = where
        ta, tb = self._site_tensor(a), self._site_tensor(b)
        central = list(bonds(ta, tb))
        central_ix = central[0] if central else None

        # absorb the environment's gauges into the pair
        absorbed = []
        for t, coo in ((ta, a), (tb, b)):
            for ix in t.inds:
                if ix != central_ix and ix in self.gauges:
                    t.multiply_index_diagonal_(
                        ix, self.gauges[ix] + self.gauge_smudge)
                    absorbed.append((coo, ix))
        if central_ix is not None and central_ix in self.gauges:
            s = self.gauges[central_ix]
            ta.multiply_index_diagonal_(central_ix, torch.sqrt(s))
            tb.multiply_index_diagonal_(central_ix, torch.sqrt(s))

        # expand the bond fully, no truncation yet
        gate_opts = dict(self.gate_opts)
        max_bond = gate_opts.pop("max_bond", self._D)
        gate_opts["cutoff"] = 0.0
        gate_opts["max_bond"] = None
        psi.gate_(U, where, contract="reduce-split", **gate_opts)

        ta, tb = self._site_tensor(a), self._site_tensor(b)
        central = list(bonds(ta, tb))
        if central and ta.ind_size(central[0]) > max_bond:
            self._cluster_compress(a, b, central[0], max_bond)
        if central:
            # re-canonicalize the pair: no further truncation, but
            # well-conditioned Vidal tensors and the bond's gauge
            ta, tb = self._site_tensor(a), self._site_tensor(b)
            out = tensor_compress_bond(ta, tb, absorb=None,
                                       max_bond=max_bond, cutoff=0.0)
            if out is not None and len(out) == 3:
                s = out[1]
                self.gauges[central[0]] = s / torch.linalg.norm(s)

        # take the environment's gauges out again
        for coo, ix in absorbed:
            t = self._site_tensor(coo)
            if ix in t.inds and ix in self.gauges:
                t.multiply_index_diagonal_(
                    ix, 1 / (self.gauges[ix] + self.gauge_smudge))
        for coo in (a, b):
            t = self._site_tensor(coo)
            nrm = float(t.norm())
            HOST_READS["site norm"] += 1
            if nrm > 0:
                t.modify(apply=lambda d, nrm=nrm: d / nrm)

    def _cluster_compress(self, a, b, bix, max_bond):
        """Fit projectors to the cluster environment and insert them on
        the bond."""
        psi = self.state
        sites = self._cluster_sites(a, b)
        ta, tb = self._site_tensor(a), self._site_tensor(b)

        kts = {}
        for site in sites:
            t = self._site_tensor(site).copy()
            if site not in (a, b):
                for ix in t.inds:
                    if ix not in self.gauges:
                        continue
                    holders = psi.ind_map.get(ix, ())
                    sites_holding = {
                        s2 for s2 in sites
                        if any(tid in holders for tid in
                               psi._get_tids_from_tags(psi.site_tag(s2),
                                                       "any"))}
                    if a in sites_holding or b in sites_holding:
                        continue  # absorbed on the pair's side already
                    g = self.gauges[ix] + self.gauge_smudge
                    t.multiply_index_diagonal_(
                        ix, torch.sqrt(g) if len(sites_holding) > 1 else g)
            kts[site] = t
        kts[a] = kts[a].reindex({bix: "__kl__"})
        kts[b] = kts[b].reindex({bix: "__kr__"})

        ket = TensorNetwork([kts[s] for s in sites], virtual=True,
                            check_collisions=False)
        bra = ket.conj()
        bra.reindex_({"__kl__": "__bl__", "__kr__": "__br__"})
        bra.mangle_inner_("*")
        # the physical and dangling bonds stay shared: traced with weight
        E_t = TensorNetwork((ket, bra), virtual=True,
                            check_collisions=False).contract(
            ..., output_inds=("__kl__", "__kr__", "__bl__", "__br__"),
            preserve_tensor=True)
        Pl, s, Pr = fit_bondenv_projectors(
            E_t.data, max_bond, max_iterations=self.fit_iterations,
            tol=self.fit_tol)

        ta.reindex_({bix: "__kl__"})
        tb.reindex_({bix: "__kr__"})
        new_ta = tensor_contract(ta, Tensor(Pl, inds=("__kl__", bix)),
                                 preserve_tensor=True)
        new_tb = tensor_contract(Tensor(Pr, inds=(bix, "__kr__")), tb,
                                 preserve_tensor=True)
        for t, new, old in ((ta, new_ta, "__kl__"), (tb, new_tb, "__kr__")):
            inds = tuple(bix if ix == old else ix for ix in t.inds)
            t.modify(data=new.transpose(*inds).data, inds=inds)
