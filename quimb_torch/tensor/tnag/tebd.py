"""Arbitrary-geometry TEBD / simple update.

Port of quimb_tpu's ``tensor/tnag/tebd.py`` (reference
``quimb/tensor/tnag/tebd.py``: ``LocalHamGen`` :78 with cached gate expm
:249, ``TEBDGen`` :1160, ``SimpleUpdateGen`` :1307, ``edge_coloring``
:24). The terms and the cached gates are host numpy arrays, as in
:class:`~quimb_torch.tensor.tn2d.tebd.LocalHam2D`; each gate acts on the
device of the state's tensors. A gate of ``SimpleUpdateGen`` reads two
tensor norms to the host (the per-site renormalisation), and its split
one rank, as quimb_tpu's does; ``progbar`` is accepted and shows nothing.
"""

import itertools

import numpy as np
import torch

from ..core import bonds, tensor_compress_bond
from ..tn1d.tebd import _expm_herm
from .core import edge_coloring


class LocalHamGen:
    """Sum of 2-site (+1-site) terms on an arbitrary graph
    (reference ``LocalHamGen`` tnag/tebd.py:78)."""

    def __init__(self, H2, H1=None):
        self.terms = {
            tuple(k): np.asarray(v) for k, v in dict(H2).items()
        }
        if H1 is not None:
            # one array is every site's term (quimb_tpu drops it)
            H1 = (dict(H1) if not hasattr(H1, "shape") else
                  dict.fromkeys(self.sites, H1))
        # absorb single site terms
        if H1:
            nbonds = {}
            for (a, b) in self.terms:
                nbonds[a] = nbonds.get(a, 0) + 1
                nbonds[b] = nbonds.get(b, 0) + 1
            for site, h1 in H1.items():
                h1 = np.asarray(h1)
                d = h1.shape[0]
                I = np.eye(d)
                share = 1.0 / nbonds.get(site, 1)
                for (a, b) in self.terms:
                    if a == site:
                        self.terms[(a, b)] = self.terms[(a, b)] + \
                            share * np.kron(h1, I)
                    elif b == site:
                        self.terms[(a, b)] = self.terms[(a, b)] + \
                            share * np.kron(I, h1)
        self._gate_cache = {}

    @property
    def sites(self):
        return tuple(sorted(set(
            itertools.chain.from_iterable(self.terms)
        )))

    def items(self):
        return self.terms.items()

    def get_term(self, where):
        try:
            return self.terms[tuple(where)]
        except KeyError:
            return self.terms[(where[1], where[0])]

    def get_gate_expm(self, where, x):
        """Cached host array expm(x * H_where) (reference
        tnag/tebd.py:249), computed in float64 (complex128 for a complex
        ``x`` or term): a real factor keeps the gate of a real term real,
        so the splits downstream stay real."""
        key = (tuple(where), complex(x))
        try:
            return self._gate_cache[key]
        except KeyError:
            xc = complex(x)
            factor = xc.real if xc.imag == 0 else xc
            H = torch.as_tensor(np.asarray(self.get_term(where)))
            if not H.is_complex():
                H = H.to(torch.float64)
            U = self._gate_cache[key] = _expm_herm(H, factor).numpy()
            return U

    def __repr__(self):
        return f"<LocalHamGen(nsites={len(self.sites)}, " \
               f"nterms={len(self.terms)})>"


def ham_gen_heis(edges, j=1.0, bz=0.0):
    """Heisenberg LocalHamGen on arbitrary edges."""
    from ...gen.operators import _spin_op_np

    S = {s: _spin_op_np(s, 0.5) for s in "xyz"}
    h2 = sum(np.kron(S[s], S[s]) for s in "xyz").real * j
    H2 = {tuple(e): h2 for e in edges}
    H1 = None
    if bz:
        sites = sorted(set(itertools.chain.from_iterable(edges)))
        H1 = {s: -bz * S["z"].real for s in sites}
    return LocalHamGen(H2, H1)


class TEBDGen:
    """Arbitrary-geometry imaginary/real time evolution
    (reference ``TEBDGen`` tnag/tebd.py:1160)."""

    def __init__(self, psi0, ham, tau=0.01, D=None, imag=True,
                 gate_opts=None, ordering=None, compute_energy_every=None,
                 compute_energy_final=True, compute_energy_opts=None,
                 callback=None, progbar=False, **kwargs):
        self.state = psi0.copy()
        self.ham = ham
        self.tau = tau
        self.imag = imag
        self._D = D if D is not None else (psi0.max_bond() or 2)
        self.gate_opts = dict(gate_opts or {})
        self.gate_opts.setdefault("cutoff", 1e-10)
        self.gate_opts.setdefault("max_bond", self._D)
        self.ordering = ordering
        self.compute_energy_every = compute_energy_every
        self.compute_energy_final = compute_energy_final
        self.compute_energy_opts = dict(compute_energy_opts or {})
        self.callback = callback
        self.progbar = progbar
        self.n = 0
        self.its = []
        self.taus = []
        self.energies = []

    @property
    def D(self):
        return self._D

    def get_ordering(self):
        if self.ordering is not None:
            return self.ordering
        # edge-colored ordering: commuting groups consecutive
        colors = edge_coloring(self.ham.terms)
        return [e for color in colors for e in color]

    def gate(self, U, where):
        self.state.gate_(
            U, where, contract="reduce-split", **self.gate_opts
        )

    def sweep(self, tau):
        factor = -tau if self.imag else -1j * tau
        for where in self.get_ordering():
            U = self.ham.get_gate_expm(where, factor)
            self.gate(U, where)
        if self.imag:
            self.normalize_state()

    def normalize_state(self):
        for t in self.state:
            nrm = float(t.norm())
            if nrm > 0:
                t.modify(apply=lambda d, nrm=nrm: d / nrm)

    def compute_energy(self):
        opts = dict(self.compute_energy_opts)
        method = opts.pop("method", "cluster")
        return float(np.real(self.state.compute_local_expectation(
            self.ham.terms, method=method, **opts,
        )))

    @property
    def energy(self):
        if not self.energies:
            self.energies.append(self.compute_energy())
        return self.energies[-1]

    def evolve(self, steps, tau=None, progbar=None):
        if tau is not None:
            self.tau = tau
        for _ in range(steps):
            self.sweep(self.tau)
            self.n += 1
            self.its.append(self.n)
            self.taus.append(self.tau)
            if self.compute_energy_every and \
                    self.n % self.compute_energy_every == 0:
                self.energies.append(self.compute_energy())
                if self.callback is not None:
                    self.callback(self)
        if self.compute_energy_final:
            self.energies.append(self.compute_energy())
        return self

    def get_state(self):
        return self.state.copy()

    def assemble_plot_data(self):
        return {"its": self.its, "taus": self.taus,
                "energies": self.energies}

    def plot(self, **kwargs):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        n = min(len(self.its), len(self.energies))
        ax.plot(self.its[:n], self.energies[:n], marker="o")
        ax.set_xlabel("iteration")
        ax.set_ylabel("energy")
        return fig, ax


class SimpleUpdateGen(TEBDGen):
    """Simple update with Vidal gauges on an arbitrary graph
    (reference ``SimpleUpdateGen`` tnag/tebd.py:1307)."""

    def __init__(self, psi0, ham, tau=0.01, D=None, gauge_smudge=1e-6,
                 **kwargs):
        super().__init__(psi0, ham, tau=tau, D=D, **kwargs)
        self.gauge_smudge = gauge_smudge
        self.gauges = {}

    def _site_tensor(self, site):
        return self.state[self.state.site_tag(site)]

    def gate(self, U, where):
        psi = self.state
        a, b = where
        ta, tb = self._site_tensor(a), self._site_tensor(b)
        central = list(bonds(ta, tb))
        central_ix = central[0] if central else None

        absorbed = []
        for (t, coo) in ((ta, a), (tb, b)):
            for ix in t.inds:
                if ix != central_ix and ix in self.gauges:
                    t.multiply_index_diagonal_(
                        ix, self.gauges[ix] + self.gauge_smudge
                    )
                    absorbed.append((coo, ix))
        if central_ix is not None and central_ix in self.gauges:
            s = self.gauges[central_ix]
            ta.multiply_index_diagonal_(central_ix, torch.sqrt(s))
            tb.multiply_index_diagonal_(central_ix, torch.sqrt(s))

        psi.gate_(U, where, contract="reduce-split", **self.gate_opts)

        ta, tb = self._site_tensor(a), self._site_tensor(b)
        central = list(bonds(ta, tb))
        if central:
            out = tensor_compress_bond(
                ta, tb, absorb=None,
                max_bond=self.gate_opts.get("max_bond"), cutoff=0.0,
            )
            if len(out) == 3:
                _, s, _ = out
                s = s / torch.linalg.norm(s)
                self.gauges[central[0]] = s

        for (coo, ix) in absorbed:
            t = self._site_tensor(coo)
            if ix in t.inds and ix in self.gauges:
                t.multiply_index_diagonal_(
                    ix, 1 / (self.gauges[ix] + self.gauge_smudge)
                )

        for coo in (a, b):
            t = self._site_tensor(coo)
            nrm = float(t.norm())
            if nrm > 0:
                t.modify(apply=lambda d, nrm=nrm: d / nrm)

    def normalize_state(self):
        pass  # conditioning happens per-gate

    def get_state(self, absorb_gauges=True):
        psi = self.state.copy()
        if absorb_gauges:
            psi.gauge_simple_insert(self.gauges)
        return psi

    def compute_energy(self):
        psi = self.get_state()
        opts = dict(self.compute_energy_opts)
        method = opts.pop("method", "cluster")
        return float(np.real(psi.compute_local_expectation(
            self.ham.terms, method=method, **opts,
        )))


# ---------------------------------------------------------------------------
# LocalHamGen parity extras (reference tnag/tebd.py:273-360)
# ---------------------------------------------------------------------------

def _lhg_nsites(self):
    return len(self.sites)


def _lhg_get_gate(self, where):
    """The local term for pair ``where`` (reference ``get_gate``
    tnag/tebd.py:273)."""
    return self.get_term(where)


def _lhg_apply_to_arrays(self, fn):
    """Apply ``fn`` to every term array (reference
    ``apply_to_arrays`` tnag/tebd.py:283)."""
    for k in tuple(self.terms):
        self.terms[k] = fn(self.terms[k])
    self._gate_cache.clear()
    return self


def _lhg_get_auto_ordering(self, order="sort", **kwargs):
    """An ordering of the terms grouped greedily into commuting
    (non-overlapping) sets (reference ``get_auto_ordering``
    tnag/tebd.py:291)."""
    import random as _random

    if order is None:
        pairs = list(self.terms)
    elif order == "sort":
        try:
            pairs = sorted(self.terms)
        except TypeError:
            pairs = sorted(self.terms, key=str)
    elif order == "random":
        pairs = list(self.terms)
        _random.shuffle(pairs)
    elif order == "random-ungrouped":
        pairs = list(self.terms)
        _random.shuffle(pairs)
        return pairs
    else:
        colors = edge_coloring(list(self.terms))
        out = []
        for grp in colors:
            out.extend(grp)
        return out
    # greedily group into non-overlapping sets
    remaining = dict.fromkeys(pairs)
    ordering = []
    while remaining:
        cover = set()
        for pair in tuple(remaining):
            a, b = pair
            if a not in cover and b not in cover:
                ordering.append(pair)
                del remaining[pair]
                cover.add(a)
                cover.add(b)
    return ordering


def _lhg_draw(self, **kwargs):
    """Print (or plot) the interaction graph (reference ``draw``
    tnag/tebd.py)."""
    try:
        import matplotlib.pyplot as plt
        import math as _math

        sites = self.sites
        pos = {
            s: (_math.cos(2 * _math.pi * i / len(sites)),
                _math.sin(2 * _math.pi * i / len(sites)))
            for i, s in enumerate(sites)
        }
        fig, ax = plt.subplots()
        for (a, b) in self.terms:
            ax.plot([pos[a][0], pos[b][0]], [pos[a][1], pos[b][1]],
                    "-o", color="tab:blue")
        return fig, ax
    except Exception:
        for a, b in self.terms:
            print(f"  {a} -- {b}")
        return None


LocalHamGen.nsites = property(_lhg_nsites)
LocalHamGen.get_gate = _lhg_get_gate
LocalHamGen.apply_to_arrays = _lhg_apply_to_arrays
LocalHamGen.get_auto_ordering = _lhg_get_auto_ordering
LocalHamGen.draw = _lhg_draw
LocalHamGen.graph = _lhg_draw
