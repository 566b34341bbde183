"""3D local Hamiltonians and simple update.

Port of quimb_tpu's ``tensor/tn3d/tebd.py`` (reference
``quimb/tensor/tn3d/tebd.py``: ``LocalHam3D``). The terms and their gates
are host numpy arrays; the gating moves each gate to the state's device.
quimb_tpu exponentiates every gate with a complex factor, so an
imaginary-time step turns a real state complex (with zero imaginary
parts), and the port does the same.
"""

import itertools

import numpy as np
import torch

from ...gen.operators import _spin_op_np
from ...ops.backend import to_host
from ..core import bonds, tensor_compress_bond
from ..tn2d.tebd import _expm_herm
from .core import gen_3d_bonds


class LocalHam3D:
    """Sum of local 2-site terms on a 3D lattice (reference
    ``LocalHam3D``); single-site terms are shared out over the bonds of
    their site. The terms are host numpy arrays."""

    def __init__(self, Lx, Ly, Lz, H2, H1=None):
        self.Lx, self.Ly, self.Lz = Lx, Ly, Lz
        if hasattr(H2, "shape"):
            H2 = {None: H2}
        H2 = dict(H2 or {})
        default2 = H2.get(None)
        self.terms = {}
        for pair in gen_3d_bonds(Lx, Ly, Lz):
            h = H2.get(pair, H2.get((pair[1], pair[0]), default2))
            if h is not None:
                self.terms[pair] = to_host(h)
        if H1 is not None:
            if hasattr(H1, "shape"):
                H1 = {None: H1}
            H1 = dict(H1)
            default1 = H1.get(None)
            nbonds = {}
            for (a, b) in self.terms:
                nbonds[a] = nbonds.get(a, 0) + 1
                nbonds[b] = nbonds.get(b, 0) + 1
            for coo in itertools.product(range(Lx), range(Ly), range(Lz)):
                h1 = H1.get(coo, default1)
                if h1 is None:
                    continue
                h1 = to_host(h1)
                I = np.eye(h1.shape[0])
                share = 1.0 / nbonds.get(coo, 1)
                for (a, b) in self.terms:
                    if a == coo:
                        self.terms[(a, b)] = self.terms[(a, b)] + \
                            share * np.kron(h1, I)
                    elif b == coo:
                        self.terms[(a, b)] = self.terms[(a, b)] + \
                            share * np.kron(I, h1)
        self._gate_cache = {}

    @property
    def nsites(self):
        return self.Lx * self.Ly * self.Lz

    def get_term(self, where):
        try:
            return self.terms[tuple(where)]
        except KeyError:
            return self.terms[(where[1], where[0])]

    def get_gate_expm(self, where, x):
        """Cached host array ``expm(x * H_where)`` in complex128."""
        key = (tuple(where), complex(x))
        try:
            return self._gate_cache[key]
        except KeyError:
            H = torch.as_tensor(np.asarray(self.get_term(where)))
            if not H.is_complex():
                H = H.to(torch.float64)
            U = self._gate_cache[key] = _expm_herm(H, complex(x)).numpy()
            return U

    def __repr__(self):
        return f"<LocalHam3D(Lx={self.Lx}, Ly={self.Ly}, Lz={self.Lz})>"


def ham_3d_heis(Lx, Ly, Lz, j=1.0, bz=0.0):
    """The 3D Heisenberg model ``j S.S`` on every bond, with a field
    ``-bz S^z`` (reference ``ham_3d_heis``)."""
    S = {s: _spin_op_np(s, 0.5) for s in "xyz"}
    h2 = sum(np.kron(S[s], S[s]) for s in "xyz").real * j
    H1 = -bz * S["z"].real if bz else None
    return LocalHam3D(Lx, Ly, Lz, h2, H1)


class SimpleUpdate3D:
    """Vidal simple update on a 3D PEPS (reference tn3d simple update,
    the pattern of the 2D one), one gate at a time on the state's device.
    Each gate ends with one host read of each site tensor's norm, as in
    quimb_tpu."""

    def __init__(self, psi0, ham, D=None, gauge_smudge=1e-6,
                 gate_opts=None):
        self.state = psi0.copy()
        self.ham = ham
        self._D = D if D is not None else (psi0.max_bond() or 2)
        self.gauge_smudge = gauge_smudge
        self.gate_opts = dict(gate_opts or {})
        self.gate_opts.setdefault("max_bond", self._D)
        self.gate_opts.setdefault("cutoff", 1e-10)
        self.gauges = {}
        self.n = 0

    def _t(self, coo):
        return self.state[self.state.site_tag(*coo)]

    def gate(self, U, where):
        psi = self.state
        a, b = where
        ta, tb = self._t(a), self._t(b)
        central = list(bonds(ta, tb))
        cix = central[0] if central else None
        absorbed = []
        for (t, coo) in ((ta, a), (tb, b)):
            for ix in t.inds:
                if ix != cix and ix in self.gauges:
                    t.multiply_index_diagonal_(
                        ix, self.gauges[ix] + self.gauge_smudge
                    )
                    absorbed.append((coo, ix))
        if cix is not None and cix in self.gauges:
            s = torch.sqrt(self.gauges[cix])
            ta.multiply_index_diagonal_(cix, s)
            tb.multiply_index_diagonal_(cix, s)
        psi.gate_(U, where, contract="reduce-split", **self.gate_opts)
        ta, tb = self._t(a), self._t(b)
        central = list(bonds(ta, tb))
        if central:
            out = tensor_compress_bond(
                ta, tb, absorb=None, max_bond=self._D, cutoff=0.0
            )
            if len(out) == 3:
                s = out[1]
                self.gauges[central[0]] = s / torch.linalg.vector_norm(s)
        for (coo, ix) in absorbed:
            t = self._t(coo)
            if ix in t.inds and ix in self.gauges:
                t.multiply_index_diagonal_(
                    ix, 1 / (self.gauges[ix] + self.gauge_smudge)
                )
        for coo in (a, b):
            t = self._t(coo)
            nrm = float(t.norm())
            if nrm > 0:
                t.modify(apply=lambda d, nrm=nrm: d / nrm)

    def sweep(self, tau):
        for where in sorted(self.ham.terms):
            self.gate(self.ham.get_gate_expm(where, -tau), where)

    def evolve(self, steps, tau):
        for _ in range(steps):
            self.sweep(tau)
            self.n += 1
        return self

    def get_state(self, absorb_gauges=True):
        psi = self.state.copy()
        if absorb_gauges:
            for ix, s in self.gauges.items():
                tids = tuple(psi.ind_map.get(ix, ()))
                if len(tids) == 2:
                    sq = torch.sqrt(s)
                    for tid in tids:
                        psi.tensor_map[tid].multiply_index_diagonal_(
                            ix, sq
                        )
        return psi
