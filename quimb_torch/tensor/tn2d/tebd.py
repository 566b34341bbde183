"""2D imaginary / real time evolution: LocalHam2D, TEBD2D, SimpleUpdate,
FullUpdate.

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
the state on its device. ``FullUpdate`` fits every gated pair of sites to
its environment in ``<psi|psi>`` (boundary contractions at ``chi``): by
alternating least squares on the normal equations (the default), or by
L-BFGS on the environment-weighted fidelity with ``torch.autograd``.
"""

import itertools

import numpy as np
import torch

from ...ops.backend import numpy_dtype, to_host
from ..core import Tensor, TensorNetwork, bonds, tensor_balance_bond, \
    tensor_contract
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


def _autodiff_plaquette_fitter(ax_a, ax_b, perm, m, p, nsteps):
    """The fidelity fitter of :meth:`FullUpdate._fit_autodiff`:
    ``fit(xa0, xb0, E, ET)`` maximizes ``|<f|E|t>|^2 / <f|E|f>`` over the
    two site arrays, ``f`` their contraction over axes ``ax_a`` / ``ax_b``
    permuted by ``perm`` to an (m, p) matrix, with ``E`` (m, m) the
    environment and ``ET`` (m, p) its product with the target.

    ``nsteps`` steps of ``torch.optim.LBFGS`` (one iteration each, a
    strong-Wolfe line search, the gradient by ``torch.autograd``) on the
    arrays' device; the best loss of every point evaluated is kept, and
    its arrays returned. (quimb_tpu runs optax's L-BFGS in one
    ``lax.scan`` of ``nsteps`` iterations and keeps the best iterate; the
    line searches differ, so the two agree in fidelity, not in arrays.)
    Complex arrays are optimized as their real views."""

    def plaquette(xa, xb):
        t = torch.tensordot(xa, xb, dims=([ax_a], [ax_b]))
        return torch.reshape(t.permute(perm), (m, p))

    def fit(xa0, xb0, E, ET):
        cplx = xa0.is_complex()
        params = [torch.clone((torch.view_as_real(x) if cplx else x)
                              .detach(),
                              memory_format=torch.contiguous_format)
                  .requires_grad_(True) for x in (xa0, xb0)]

        def arrays():
            return [torch.view_as_complex(q) if cplx else q for q in params]

        def loss_fn():
            f = plaquette(*arrays())
            fh = torch.conj(f.T)
            tf = torch.trace(fh @ ET)
            ff = torch.trace(fh @ (E @ f)).real
            return -(torch.abs(tf) ** 2) / ff

        best = {"val": float("inf"), "params": [q.detach().clone()
                                                for q in params]}

        def closure():
            opt.zero_grad()
            loss = loss_fn()
            loss.backward()
            val = float(loss.detach())
            if val < best["val"]:
                best["val"] = val
                best["params"] = [q.detach().clone() for q in params]
            return loss

        # one iteration a step; its line search may take 25 evaluations
        # (LBFGS caps the search at max_eval less the evaluations made)
        opt = torch.optim.LBFGS(params, max_iter=1, max_eval=26,
                                line_search_fn="strong_wolfe")
        for _ in range(nsteps):
            opt.step(closure)
        with torch.no_grad():
            final = float(loss_fn())
        if final < best["val"]:
            best["params"] = [q.detach().clone() for q in params]
        return tuple(torch.view_as_complex(q) if cplx else q
                     for q in best["params"])

    return fit


class FullUpdate(TEBD2D):
    """Full update: each gated pair of sites is fitted against its whole
    environment in ``<psi|psi>``, from boundary contractions at ``chi``
    (reference ``FullUpdate`` tn2d/tebd.py:968, ``gate_full_update_als``
    :724).

    Per gate the environment of the two sites comes from row-boundary
    environments of ``<psi|psi>``, and the gated pair is fitted at a fixed
    bond dimension by solving each site's normal equations ``N x = b`` in
    turn (the environment does not touch the physical index, so ``N`` acts
    on the bond space only and the physical index rides along as the
    solve's columns).

    Parameters
    ----------
    fit_steps : int
        The most ALS sweeps per gate (the autodiff fit takes four times as
        many L-BFGS steps).
    fit_tol : float
        The relative change of the cost that ends the ALS sweeps.
    pos_smudge : float
        The diagonal shift, relative to ``|tr N| / dim N + 1``, that keeps
        ``N`` positive.
    fit_strategy : {'als', 'autodiff'}
        The gate fit.
    compute_envs_every : int
        Recompute the row-boundary environments only every this many
        gates while the state's bond sizes stay the same (reference
        tn2d/tebd.py:1164).
    """

    compute_envs_every = 1

    def __init__(self, psi0, ham, *, fit_steps=12, fit_tol=1e-10,
                 pos_smudge=1e-8, fit_strategy="als",
                 compute_envs_every=1, **kwargs):
        kwargs.setdefault("gate_opts", {}).setdefault("cutoff", 0.0)
        super().__init__(psi0, ham, **kwargs)
        self.fit_steps = fit_steps
        self.fit_tol = fit_tol
        self.pos_smudge = pos_smudge
        self.fit_strategy = fit_strategy
        self.compute_envs_every = compute_envs_every
        self._env_counter = 0
        self._x_envs_cache = None
        self._env_sig = None

    @property
    def fit_strategy(self):
        """The gate fit: ``'als'`` (alternating least squares on the
        normal equations, reference ``gate_full_update_als``
        tn2d/tebd.py:724) or ``'autodiff'`` (L-BFGS on the
        environment-weighted fidelity, reference
        ``gate_full_update_autodiff_fidelity`` tn2d/tebd.py:851)."""
        return self._fit_strategy

    @fit_strategy.setter
    def fit_strategy(self, v):
        if v not in ("als", "autodiff"):
            raise ValueError(
                f"fit_strategy must be 'als' or 'autodiff', got {v!r}")
        self._fit_strategy = v

    def set_state(self, psi):
        """Replace the evolving state (reference ``set_state``
        tn2d/tebd.py:1153)."""
        self.state = psi.copy()
        return self

    def presweep(self, i=None):
        """The hook run before each sweep (reference ``presweep``
        tn2d/tebd.py:1243): each gate forms its own environment, so there
        is nothing to prepare."""
        return self

    def _get_x_envs(self, norm):
        """The row-boundary environments of ``norm``, recomputed every
        ``compute_envs_every`` gates, or whenever a bond of the state has
        changed size (early gates can still grow bonds); in between the
        stale ones are reused."""
        sig = tuple(sorted((ix, self.state.ind_size(ix))
                           for ix in self.state.ind_map))
        if (self.compute_envs_every <= 1 or self._x_envs_cache is None
                or self._env_counter % self.compute_envs_every == 0
                or self._env_sig != sig):
            self._x_envs_cache = norm.compute_x_environments(
                max_bond=self._chi)
            self._env_sig = sig
        self._env_counter += 1
        return self._x_envs_cache

    def _plaquette_env(self, norm, a, b):
        """The environment of sites ``a`` and ``b``: the row-boundary
        environments below and above their rows with the rows between,
        less the four tensors of the two sites."""
        psi = self.state
        x_envs = self._get_x_envs(norm)
        x0, x1 = min(a[0], b[0]), max(a[0], b[0])
        strip = TensorNetwork(())
        bot = x_envs.get(("xmin", x0))
        if bot is not None and bot.num_tensors:
            strip.add_tensor_network(bot.copy(), virtual=True,
                                     check_collisions=False)
        for x in range(x0, x1 + 1):
            strip.add_tensor_network(
                norm.select(norm.x_tag(x), which="any").copy(),
                virtual=True, check_collisions=False)
        top = x_envs.get(("xmax", x1))
        if top is not None and top.num_tensors:
            strip.add_tensor_network(top.copy(), virtual=True,
                                     check_collisions=False)
        ta, tb = psi.site_tag(*a), psi.site_tag(*b)
        return strip.select((ta, tb), which="!any")

    @staticmethod
    def _make_bra(ket_t, phys_ind):
        """The conjugate of a site tensor in the mangled bra layer."""
        inds = tuple(ix if ix == phys_ind else ix + "*" for ix in ket_t.inds)
        return Tensor(torch.conj(ket_t.data), inds=inds)

    def _fit_autodiff(self, env, target, fit_a, fit_b, pa, pb):
        """Fit the gated pair by L-BFGS on the environment-weighted
        fidelity (reference ``gate_full_update_autodiff_fidelity``
        tn2d/tebd.py:851): the environment is made dense once over the
        pair's external bonds, ``E @ target`` once, and
        :func:`_autodiff_plaquette_fitter` optimizes the two arrays."""
        inds_a, inds_b = fit_a.inds, fit_b.inds
        (new_bond,) = bonds(fit_a, fit_b)
        ext = (tuple(ix for ix in inds_a if ix not in (new_bond, pa))
               + tuple(ix for ix in inds_b if ix not in (new_bond, pb)))
        ext_star = tuple(ix + "*" for ix in ext)
        # the dense environment over (bra ext | ket ext)
        E = env.to_dense(ext_star, ext)
        E = (E + torch.conj(E.T)) / 2
        # the dense gated target over (ket ext | phys)
        T = target.to_dense(ext, (pa, pb))
        ET = E @ T.to(E.dtype)
        # the contraction over the shared bond, then the permutation of
        # the remaining axes to (ext..., pa, pb)
        ax_a, ax_b = inds_a.index(new_bond), inds_b.index(new_bond)
        rem = ([ix for ix in inds_a if ix != new_bond]
               + [ix for ix in inds_b if ix != new_bond])
        perm = tuple(rem.index(ix) for ix in ext + (pa, pb))
        fitter = _autodiff_plaquette_fitter(
            ax_a, ax_b, perm, E.shape[0], T.shape[1],
            max(self.fit_steps, 1) * 4)
        xa, xb = fitter(fit_a.data, fit_b.data, E, ET)
        fit_a.modify(data=xa)
        fit_b.modify(data=xb)

    def _fit_als(self, env, target, fit_a, fit_b, pa, pb):
        """Fit the gated pair by alternating least squares: each site in
        turn solves its normal equations ``N x = b`` with the other fixed,
        for at most ``fit_steps`` sweeps or until the cost moves by less
        than ``fit_tol`` relative (one host read of the cost per sweep)."""
        prev_cost = None
        for _ in range(self.fit_steps):
            for fit_s, fit_o, ps, po in ((fit_a, fit_b, pa, pb),
                                         (fit_b, fit_a, pb, pa)):
                bond_ixs = tuple(ix for ix in fit_s.inds if ix != ps)
                lix = tuple(ix + "*" for ix in bond_ixs)
                bra_o = self._make_bra(fit_o, po)
                # the normal matrix over the site's bond space
                N = TensorNetwork((env, bra_o, fit_o.copy()), virtual=False,
                                  check_collisions=False).to_dense(
                                      lix, bond_ixs)
                N = (N + torch.conj(N.T)) / 2
                dN = N.shape[0]
                N = N + (self.pos_smudge
                         * (torch.abs(torch.trace(N)) / dN + 1.0)
                         ) * torch.eye(dN, dtype=N.dtype, device=N.device)
                # the right-hand side: the environment-weighted overlap
                # with the target
                bvec = TensorNetwork((env, bra_o, target), virtual=False,
                                     check_collisions=False).to_dense(
                                         lix, (ps,)).to(N.dtype)
                x = torch.linalg.solve(N, bvec)
                shape = (tuple(fit_s.ind_size(ix) for ix in bond_ixs)
                         + (fit_s.ind_size(ps),))
                fit_s.modify(data=torch.reshape(x, shape),
                             inds=bond_ixs + (ps,))
            xh = torch.conj(x.T)
            cost = float(-2.0 * torch.trace(xh @ bvec).real
                         + torch.abs(torch.trace(xh @ (N @ x))))
            if prev_cost is not None and abs(cost - prev_cost) <= (
                    self.fit_tol * max(abs(cost), 1e-30)):
                break
            prev_cost = cost

    def gate(self, U, where):
        """Apply the gate ``U`` to the pair ``where``: the reduce-split
        application is the fit's start, the gated pair (kept lazy) its
        target; the fitted pair's new bond is balanced and each tensor
        keeps its norm."""
        from ..gating import tensor_network_gate_inds

        psi = self.state
        a, b = where
        ta, tb = psi.site_tag(*a), psi.site_tag(*b)
        pa, pb = psi.site_ind(*a), psi.site_ind(*b)

        norm = psi.make_norm()
        env = self._plaquette_env(norm, a, b)
        ket_a0, ket_b0 = psi[ta].copy(), psi[tb].copy()
        na0, nb0 = float(ket_a0.norm()), float(ket_b0.norm())
        # the fixed target: the pair with the gate applied lazily
        target = tensor_network_gate_inds(
            TensorNetwork((ket_a0.copy(), ket_b0.copy())), U, (pa, pb),
            contract=False)
        # the start: the reduce-split application
        guess = tensor_network_gate_inds(
            TensorNetwork((ket_a0.copy(), ket_b0.copy())), U, (pa, pb),
            contract="reduce-split",
            max_bond=self.gate_opts.get("max_bond", self._D), cutoff=0.0)
        fit_a, fit_b = guess[ta], guess[tb]
        if self._fit_strategy == "autodiff":
            self._fit_autodiff(env, target, fit_a, fit_b, pa, pb)
        else:
            self._fit_als(env, target, fit_a, fit_b, pa, pb)

        # balance the new bond and restore the original norms (reference
        # condition_maintain_norms)
        if bonds(fit_a, fit_b):
            tensor_balance_bond(fit_a, fit_b)
        cna, cnb = float(fit_a.norm()), float(fit_b.norm())
        if cna > 0 and na0 > 0:
            fit_a.modify(apply=lambda d: d * (na0 / cna))
        if cnb > 0 and nb0 > 0:
            fit_b.modify(apply=lambda d: d * (nb0 / cnb))
        # write back into the state under the original bond name
        (old_bond,) = bonds(psi[ta], psi[tb])
        (new_bond,) = bonds(fit_a, fit_b)
        if new_bond != old_bond:
            fit_a.reindex_({new_bond: old_bond})
            fit_b.reindex_({new_bond: old_bond})
        for live, fit in ((psi[ta], fit_a), (psi[tb], fit_b)):
            live.modify(data=fit.transpose(*live.inds).data)


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
