"""2D imaginary / real time evolution: LocalHam2D, TEBD2D, SimpleUpdate.

Port of quimb_tpu's ``tensor/tn2d/tebd.py`` (reference
``quimb/tensor/tn2d/tebd.py``: ``LocalHam2D`` :29, ``TEBD2D`` :383,
``SimpleUpdate`` :544 with its gauge dict and conditioner).

``SimpleUpdate.evolve`` runs the fused colour-class sweeps of
:mod:`.su_fused` when the state and Hamiltonian allow it (``_can_fuse``:
a rectangular PEPS, nearest-neighbour terms, truncation at ``D``), else
gate by gate; ``fused=False`` asks for the per-bond path. The fused
lattice stays on the device between ``evolve`` calls and is turned back
into a PEPS and a gauge dict only when ``state`` or ``gauges`` is read.
The terms of a :class:`LocalHam2D` are host numpy arrays; the gates join
the state on its device. ``FullUpdate`` is not ported yet and raises
naming ROADMAP item 13(b).
"""

import itertools

import numpy as np
import torch

from ...ops.backend import numpy_dtype, to_host
from ..core import _deferred, bonds, tensor_contract
from .core import gen_2d_bonds


def _expm_herm(H, factor):
    """``expm(factor * H)`` for a hermitian ``H`` via ``eigh``, on ``H``'s
    device; a real ``factor`` on a real ``H`` gives a real result."""
    w, V = torch.linalg.eigh(H)
    phases = torch.exp(factor * w)
    dt = torch.promote_types(V.dtype, phases.dtype)
    V = V.to(dt)
    return (V * phases.to(dt)) @ V.conj().T


def _unit_norm(d):
    """``d`` over its norm, the norm kept on the device; a zero array is
    left as it is."""
    n = torch.linalg.vector_norm(d)
    return d / torch.where(n > 0, n, torch.ones_like(n))


class LocalHam2D:
    """Sum of local 2-site (and 1-site) terms on a 2D lattice
    (reference ``LocalHam2D`` tn2d/tebd.py:29). The terms are host numpy
    arrays."""

    def __init__(self, Lx, Ly, H2, H1=None):
        self.Lx = Lx
        self.Ly = Ly
        if hasattr(H2, "shape"):
            H2 = {None: H2}
        H2 = dict(H2 or {})
        default2 = H2.get(None)
        self.terms = {}
        for pair in gen_2d_bonds(Lx, Ly):
            h = H2.get(pair, H2.get((pair[1], pair[0]), default2))
            if h is not None:
                self.terms[pair] = to_host(h)

        # absorb single-site terms into neighbouring bonds
        if H1 is not None:
            if hasattr(H1, "shape"):
                H1 = {None: H1}
            H1 = dict(H1)
            default1 = H1.get(None)
            # count bonds per site
            nbonds = {}
            for (a, b) in self.terms:
                nbonds[a] = nbonds.get(a, 0) + 1
                nbonds[b] = nbonds.get(b, 0) + 1
            for coo in itertools.product(range(Lx), range(Ly)):
                h1 = H1.get(coo, default1)
                if h1 is None:
                    continue
                h1 = to_host(h1)
                d = h1.shape[0]
                I = np.eye(d)
                share = 1.0 / nbonds.get(coo, 1)
                for (a, b) in self.terms:
                    if a == coo:
                        self.terms[(a, b)] = self.terms[(a, b)] + \
                            share * np.kron(h1, I)
                    elif b == coo:
                        self.terms[(a, b)] = self.terms[(a, b)] + \
                            share * np.kron(I, h1)
        self._gate_cache = {}

    def get_term(self, where):
        try:
            return self.terms[tuple(where)]
        except KeyError:
            return self.terms[(where[1], where[0])]

    def get_gate_expm(self, where, x):
        """Cached host array ``expm(x * H_where)``, computed in float64
        (complex128 for a complex ``x`` or term): a real factor keeps the
        gate of a real term real."""
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

    def build_pepo_propagator(self, x, max_bond=None, cutoff=1e-12,
                              **pepo_opts):
        """First-order Trotterized propagator ``prod_b exp(x H_b)`` as
        a PEPO (reference ``LocalHam2D`` PEPO propagator
        tn2d/tebd.py:97): bond gates applied to an identity PEPO with
        reduce-split compression."""
        from ..gating import tensor_network_gate_inds
        from .builders import PEPO_identity

        pepo = PEPO_identity(self.Lx, self.Ly, **pepo_opts)
        for where in sorted(self.terms):
            U = self.get_gate_expm(where, x)
            a, b = where
            tensor_network_gate_inds(
                pepo, U,
                (pepo.upper_ind(*a), pepo.upper_ind(*b)),
                contract="reduce-split", inplace=True,
                max_bond=max_bond, cutoff=cutoff,
            )
        return pepo

    def __repr__(self):
        return f"<LocalHam2D(Lx={self.Lx}, Ly={self.Ly})>"


def ham_2d_heis(Lx, Ly, j=1.0, bz=0.0, **kwargs):
    """2D Heisenberg LocalHam2D (spin operators)."""
    from ...gen.operators import _spin_op_np

    try:
        jx, jy, jz = j
    except TypeError:
        jx = jy = jz = j
    S = {s: _spin_op_np(s, 0.5) for s in "xyz"}
    H2 = sum(
        jj * np.kron(S[s], S[s])
        for s, jj in zip("xyz", (jx, jy, jz)) if jj
    )
    H1 = (-bz) * S["z"] if bz else None
    return LocalHam2D(Lx, Ly, H2.real if np.allclose(H2.imag, 0) else H2,
                      H1)


def ham_2d_ising(Lx, Ly, j=1.0, bx=0.0, **kwargs):
    from ...gen.operators import _spin_op_np

    S = {s: _spin_op_np(s, 0.5) for s in "xz"}
    H2 = 4 * j * np.kron(S["z"], S["z"]).real
    H1 = (-2 * bx) * S["x"].real if bx else None
    return LocalHam2D(Lx, Ly, H2, H1)


def ham_2d_j1j2(Lx, Ly, j1=1.0, j2=0.5, bz=0.0, **kwargs):
    from ...gen.operators import _spin_op_np

    S = {s: _spin_op_np(s, 0.5) for s in "xyz"}
    h = sum(np.kron(S[s], S[s]) for s in "xyz").real
    H2 = {}
    for pair in gen_2d_bonds(Lx, Ly):
        H2[pair] = j1 * h
    diag_steppers = [
        lambda i, j: (i + 1, j + 1), lambda i, j: (i + 1, j - 1),
    ]
    for pair in gen_2d_bonds(Lx, Ly, steppers=diag_steppers):
        H2[pair] = j2 * h
    ham = LocalHam2D.__new__(LocalHam2D)
    ham.Lx, ham.Ly = Lx, Ly
    ham.terms = {k: np.asarray(v) for k, v in H2.items()}
    ham._gate_cache = {}
    return ham


class TEBD2D:
    """Gate-based 2D evolution base (reference ``TEBD2D``
    tn2d/tebd.py:383). ``progbar`` is accepted and shows nothing."""

    def __init__(self, psi0, ham, tau=0.01, D=None, chi=None,
                 gate_opts=None, ordering=None, compute_energy_every=None,
                 compute_energy_final=True, callback=None, progbar=False,
                 **kwargs):
        self.state = psi0.copy()
        self.ham = ham
        self.tau = tau
        self._D = D if D is not None else (psi0.max_bond() or 2)
        self._chi = chi if chi is not None else max(8, 2 * self._D**2)
        self.gate_opts = dict(gate_opts or {})
        self.gate_opts.setdefault("cutoff", 1e-10)
        self.gate_opts.setdefault("max_bond", self._D)
        self.ordering = ordering
        self.compute_energy_every = compute_energy_every
        self.compute_energy_final = compute_energy_final
        self.callback = callback
        self.progbar = progbar
        self.n = 0
        self.its = []
        self.taus = []
        self.energies = []

    @property
    def D(self):
        return self._D

    @property
    def chi(self):
        return self._chi

    def get_ordering(self):
        if self.ordering is not None:
            return self.ordering
        return sorted(self.ham.terms)

    def gate(self, U, where):
        """Apply a 2-site gate (overridden by SimpleUpdate)."""
        self.state.gate_(
            U, where, contract="reduce-split", **self.gate_opts
        )

    def sweep(self, tau):
        for where in self.get_ordering():
            U = self.ham.get_gate_expm(where, -tau)
            self.gate(U, where)

    def compute_energy(self):
        return float(np.real(complex(self.state.compute_local_expectation(
            self.ham.terms, max_bond=self._chi, normalized=True,
        ))))

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


class SimpleUpdate(TEBD2D):
    """Simple update with Vidal-style bond gauges (reference
    ``SimpleUpdate`` tn2d/tebd.py:544)."""

    def __init__(self, psi0, ham, tau=0.01, D=None, chi=None,
                 gate_opts=None, gauge_smudge=1e-6, condition_tensors=True,
                 **kwargs):
        self._fstacks = None
        super().__init__(psi0, ham, tau=tau, D=D, chi=chi,
                         gate_opts=gate_opts, **kwargs)
        self.gauge_smudge = gauge_smudge
        self.condition_tensors = condition_tensors
        # gauges: bond pair -> singular value vector
        self.gauges = {}

    # -- lazy fused-stack residency ----------------------------------------
    # the fused engine keeps the whole lattice as device stacks across
    # ``evolve`` calls; a PEPS and its gauge dict are rebuilt from them
    # only when ``state`` or ``gauges`` is read.

    def _materialize(self):
        if self._fstacks is not None:
            from .su_fused import stacks_to_peps

            S, GH, GV = self._fstacks
            self._fstacks = None
            self._state, self._gauges = stacks_to_peps(
                S, GH, GV, self._state
            )

    @property
    def state(self):
        self._materialize()
        return self._state

    @state.setter
    def state(self, value):
        self._fstacks = None
        self._state = value

    @property
    def gauges(self):
        self._materialize()
        return self._gauges

    @gauges.setter
    def gauges(self, value):
        self._fstacks = None
        self._gauges = value

    def _maybe_bond(self, a, b):
        ta = self.state[self.state.site_tag(*a)]
        tb = self.state[self.state.site_tag(*b)]
        bs = list(bonds(ta, tb))
        return bs[0] if bs else None

    def _can_fuse(self):
        """Whether the batched colour-class sweeps apply: a rectangular
        PEPS, nearest-neighbour-only terms, fixed-D truncation. See
        :mod:`.su_fused` for the design."""
        from .core import PEPS

        # geometry checks only — do NOT touch ``self.state`` (that
        # would materialize the resident stacks every evolve call)
        psi = self._state
        if not isinstance(psi, PEPS) or psi.Lx < 2 or psi.Ly < 2:
            return False
        if self.gate_opts.get("max_bond") != self._D:
            return False
        # every term must be a NN bond of the lattice
        nn = set()
        for i in range(psi.Lx):
            for j in range(psi.Ly):
                if j + 1 < psi.Ly:
                    nn.add(((i, j), (i, j + 1)))
                if i + 1 < psi.Lx:
                    nn.add(((i, j), (i + 1, j)))
        for w in self.ham.terms:
            a, b = w
            if (tuple(a), tuple(b)) not in nn and \
                    (tuple(b), tuple(a)) not in nn:
                return False
        return True

    def _evolve_fused(self, steps):
        """Run ``steps`` full sweeps on the device stacks, which stay
        there between calls (see ``_materialize``)."""
        from .su_fused import (
            _axis_masks, _su_evolve, class_gate_stacks, peps_to_stacks,
        )

        psi = self._state
        Lx, Ly, D = psi.Lx, psi.Ly, self._D
        if self._fstacks is not None:
            S, GH, GV = self._fstacks
        else:
            S, GH, GV = peps_to_stacks(psi, self._gauges, D)
        p = psi.phys_dim()
        gates = class_gate_stacks(self.ham, Lx, Ly, -self.tau, p,
                                  numpy_dtype(S.dtype), S.device)
        rdt = S.real.dtype
        masks_h = _axis_masks(Lx, Ly, D, rdt, S.device)
        # the vertical pass runs on the transposed lattice
        masks_v = _axis_masks(Ly, Lx, D, rdt, S.device)
        S, GH, GV = _su_evolve(
            S, GH, GV, *gates, masks_h, masks_v,
            nsteps=int(steps), smudge=float(self.gauge_smudge),
        )
        self._fstacks = (S, GH, GV)

    def evolve(self, steps, tau=None, progbar=None, fused=None):
        """Evolve ``steps`` sweeps. Uses the fused batched sweeps when
        eligible (``fused=None`` -> ``_can_fuse``), else the per-bond
        path."""
        if tau is not None:
            self.tau = tau
        use_fused = self._can_fuse() if fused is None else fused
        if not use_fused:
            return super().evolve(steps, progbar=progbar)
        self._evolve_fused(steps)
        for _ in range(int(steps)):
            self.n += 1
            self.its.append(self.n)
            self.taus.append(self.tau)
        if self.compute_energy_every and steps:
            self.energies.append(self.compute_energy())
            if self.callback is not None:
                self.callback(self)
        if self.compute_energy_final:
            self.energies.append(self.compute_energy())
        return self

    def gate(self, U, where):
        psi = self.state
        a, b = where
        ta = psi[psi.site_tag(*a)]
        tb = psi[psi.site_tag(*b)]

        # 1. absorb environment gauges on all OTHER bonds of ta, tb
        absorbed = []
        for (t, coo) in ((ta, a), (tb, b)):
            for (pair, s) in self.gauges.items():
                if coo in pair:
                    other = pair[0] if pair[1] == coo else pair[1]
                    if other == (a if coo == b else b):
                        continue
                    bix = self._maybe_bond(coo, other)
                    if bix is not None and bix in t.inds:
                        t.multiply_index_diagonal_(
                            bix, s + self.gauge_smudge
                        )
                        absorbed.append((coo, bix, s))

        # 2. absorb the central bond gauge symmetrically & gate
        key = tuple(sorted((a, b)))
        sc = self.gauges.get(key)
        bix = self._maybe_bond(a, b)
        if sc is not None and bix is not None:
            ta.multiply_index_diagonal_(bix, torch.sqrt(sc))
            tb.multiply_index_diagonal_(bix, torch.sqrt(sc))

        psi.gate_(
            U, where, contract="reduce-split", **self.gate_opts
        )

        # 3. extract the new central gauge: canonical split of the bond
        # we use the singular values of the new bond via a local SVD
        ta = psi[psi.site_tag(*a)]
        tb = psi[psi.site_tag(*b)]
        bix = self._maybe_bond(a, b)
        if bix is not None:
            # compute new bond gauge from the two-site reduced pair
            from ..core import tensor_compress_bond

            out = tensor_compress_bond(
                ta, tb, absorb=None, max_bond=self.gate_opts.get(
                    "max_bond"), cutoff=0.0,
            )
            if len(out) == 3:
                _, s, _ = out
                s = s / torch.linalg.vector_norm(s)
                self.gauges[key] = s

        # 4. remove the absorbed environment gauges (re-fetching the
        # site tensors: gating replaced the tensor objects)
        for (coo, bix2, s) in absorbed:
            t = psi[psi.site_tag(*coo)]
            if bix2 in t.inds:
                t.multiply_index_diagonal_(
                    bix2, 1 / (s + self.gauge_smudge)
                )

        if self.condition_tensors:
            # unit-norm site tensors, the norm kept on the device (a zero
            # tensor is left as it is)
            for t in (psi[psi.site_tag(*a)], psi[psi.site_tag(*b)]):
                t.modify(apply=_unit_norm)

    def get_state(self, absorb_gauges=True):
        """The PEPS with gauges absorbed symmetrically (reference
        SimpleUpdate.get_state)."""
        psi = self.state.copy()
        if absorb_gauges:
            for (a, b), s in self.gauges.items():
                ta = psi[psi.site_tag(*a)]
                tb = psi[psi.site_tag(*b)]
                bs = list(bonds(ta, tb))
                if bs:
                    ta.multiply_index_diagonal_(bs[0], torch.sqrt(s))
                    tb.multiply_index_diagonal_(bs[0], torch.sqrt(s))
        # gauge absorption leaves site tensors with tiny norms (the
        # Vidal gauges are sub-unit); 256 sites at ~1e-3 each underflow
        # any float32 global contraction — re-balance to unit norm per
        # site (pure gauge freedom, expectation values unchanged)
        psi.equalize_norms_(1.0)
        return psi

    def compute_energy(self, method="boundary"):
        """Energy of the current state: ``'boundary'`` (accurate
        boundary-MPS environments) or ``'simple'`` (gauge-capped local
        clusters — the standard cheap simple-update estimator)."""
        if method == "simple":
            return self.compute_energy_simple()
        psi = self.get_state()
        return float(np.real(complex(psi.compute_local_expectation(
            self.ham.terms, max_bond=self._chi, normalized=True,
        ))))

    def compute_energy_simple(self):
        """Per-term 2-site cluster energies with the environment bonds
        capped by the simple-update gauges, summed on the device in
        float64 and read once."""
        psi = self.state
        vals = []
        for where, h in self.ham.terms.items():
            a, b = where
            ta = psi[psi.site_tag(*a)].copy()
            tb = psi[psi.site_tag(*b)].copy()
            central = list(bonds(ta, tb))
            cix = central[0] if central else None
            key = tuple(sorted((a, b)))
            # absorb env gauges, locating each via the other site of
            # its bond
            for (t, coo) in ((ta, a), (tb, b)):
                for pair, s in self.gauges.items():
                    if coo in pair and pair != key:
                        other = pair[0] if pair[1] == coo else pair[1]
                        ot = psi[psi.site_tag(*other)]
                        bs = [ix for ix in t.inds if ix in ot.inds]
                        if bs:
                            t.multiply_index_diagonal_(bs[0], s)
            if cix is not None and key in self.gauges:
                sq = torch.sqrt(self.gauges[key])
                ta.multiply_index_diagonal_(cix, sq)
                tb.multiply_index_diagonal_(cix, sq)
            theta = tensor_contract(
                ta, tb, output_inds=(
                    psi.site_ind(*a), psi.site_ind(*b),
                    *[ix for ix in ta.inds
                      if ix != cix and ix not in
                      (psi.site_ind(*a),)],
                    *[ix for ix in tb.inds
                      if ix != cix and ix not in
                      (psi.site_ind(*b),)],
                ), preserve_tensor=True,
            )
            ia, ib = psi.site_ind(*a), psi.site_ind(*b)
            env_inds = [ix for ix in theta.inds if ix not in (ia, ib)]
            tt = theta.transpose(ia, ib, *env_inds)
            d = psi.phys_dim(*a)
            mat = tt.data.reshape(d * d, -1)
            rho = mat @ mat.conj().T
            hloc = torch.as_tensor(np.asarray(h), device=rho.device)
            if hloc.is_complex() and not rho.is_complex():
                hloc = hloc.real
            hloc = hloc.to(rho.dtype)
            vals.append(((hloc @ rho).trace() / rho.trace()).real)
        return float(torch.stack(vals).to(torch.float64).sum())


class FullUpdate(TEBD2D):
    """Full update (reference ``FullUpdate`` tn2d/tebd.py:968): not
    ported yet."""

    def __init__(self, psi0, ham, **kwargs):
        raise _deferred("13(b)", "FullUpdate")

    def set_state(self, psi):
        """Replace the evolving state (reference ``set_state``)."""
        raise _deferred("13(b)", "FullUpdate.set_state")

    def presweep(self, i=None):
        """Hook run before each sweep (reference ``presweep``)."""
        raise _deferred("13(b)", "FullUpdate.presweep")


def _autodiff_plaquette_fitter(*args, **kwargs):
    """FullUpdate's fidelity fitter: not ported yet."""
    raise _deferred("13(b)", "FullUpdate's autodiff plaquette fitter")


# ---------------------------------------------------------------------------
# parity extras (reference tn2d/tebd.py:93-1260)
# ---------------------------------------------------------------------------

def _lh2d_nsites(self):
    return self.Lx * self.Ly


def _lh2d_build_pepo_propagator_trotterized(self, x, ordering="sort",
                                            contract_sites=True,
                                            **split_opts):
    """PEPO of ``expm(H x)`` via first-order trotterization (reference
    ``build_pepo_propagator_trotterized`` tn2d/tebd.py:97 — delegates
    to the compressed propagator builder)."""
    return self.build_pepo_propagator(x, **split_opts)


def _lh2d_draw(self, **kwargs):
    """Print (or plot, if matplotlib is available) the interaction
    graph of this Hamiltonian (reference ``draw`` tn2d/tebd.py:213)."""
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        for where in self.terms:
            print(f"  {where[0]} -- {where[1]}")
        return None
    fig, ax = plt.subplots()
    for (a, b) in self.terms:
        (xa, ya), (xb, yb) = a, b
        ax.plot([ya, yb], [-xa, -xb], "-o", color="tab:blue")
    ax.set_title(repr(self))
    return fig, ax


LocalHam2D.nsites = property(_lh2d_nsites)
LocalHam2D.build_pepo_propagator_trotterized = \
    _lh2d_build_pepo_propagator_trotterized
LocalHam2D.draw = _lh2d_draw
LocalHam2D.graph = _lh2d_draw
