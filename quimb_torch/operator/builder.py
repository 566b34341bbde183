"""SparseOperatorBuilder: second-quantised terms -> a sparse matrix, a
device matvec, an MPO or a LocalHam1D.

Port of ``quimb_tpu/operator/builder.py``, which re-designs the
reference's ``quimb/operator/builder.py`` (``SparseOperatorBuilder`` :520,
Jordan-Wigner :71, Pauli decomposition :269, coupling maps to CSR :~1173,
the MPO by a state machine :1377, :1632). The term algebra, the coupling
maps and the host COO / CSR assembly are quimb_tpu's numpy code, copied
(importing anything of quimb_tpu imports JAX). What reaches the device is
the port's: :meth:`SparseOperatorBuilder.build_sparse_ham` (the ELL
:class:`~quimb_torch.core.SparseHam`),
:meth:`~SparseOperatorBuilder.build_coupled_ham` (the matrix-free
:class:`~quimb_torch.operator.configdevice.CoupledHam`),
:meth:`~SparseOperatorBuilder.build_mpo` (the port's
``MatrixProductOperator``) and :meth:`~SparseOperatorBuilder.build_local_ham`
(its ``LocalHam1D``). Each takes ``device``, the GPU unless given.

- every term is canonicalized to a product of single-site 2x2 operators;
  acting on a basis configuration each term maps it to at most ONE other
  configuration with an amplitude: the *coupling map*.
- coupling maps are built vectorized over all sector configurations with
  numpy bit arithmetic (host, setup time), then assembled into a scipy
  matrix or packed into a ``CoupledHam``.
- the MPO is built through a greedy finite-state machine that merges terms
  by identical futures (reference ``build_state_machine_greedy``
  builder.py:1377), reaching the standard optimal bond dimensions.
"""

import collections
import functools
import itertools
import math

import numpy as np

from .hilbertspace import HilbertSpace

# single-site operators as 2x2 matrices, basis (|0>=down, |1>=up)
_OP2 = {
    "i": np.eye(2, dtype=complex),
    "x": np.array([[0, 0.5], [0.5, 0]], dtype=complex),
    "y": np.array([[0, -0.5j], [0.5j, 0]]),
    "z": np.array([[-0.5, 0], [0, 0.5]], dtype=complex),
    "sx": np.array([[0, 0.5], [0.5, 0]], dtype=complex),
    "sy": np.array([[0, -0.5j], [0.5j, 0]]),
    "sz": np.array([[-0.5, 0], [0, 0.5]], dtype=complex),
    "X": np.array([[0, 1], [1, 0]], dtype=complex),
    "Y": np.array([[0, -1j], [1j, 0]]),
    "Z": np.array([[-1, 0], [0, 1]], dtype=complex),
    "+": np.array([[0, 0], [1, 0]], dtype=complex),   # raise |0>->|1>
    "-": np.array([[0, 1], [0, 0]], dtype=complex),
    "n": np.array([[0, 0], [0, 1]], dtype=complex),
    "sn": np.array([[0, 0], [0, 1]], dtype=complex),
    "h": np.array([[1, 0], [0, 0]], dtype=complex),   # hole
}
# NOTE: convention matches the reference: |1> is the up/occupied state
# and pauli 'Z' has +1 on |1>. '+' raises |0> to |1>.

_FERMI_OPS = {"c", "cdag"}
# ops with complex entries (for dtype inference)
_OPCOMPLEX = {"y", "sy", "Y"}


class SparseOperatorBuilder:
    """Build an operator as a sum of products of local operators
    (reference ``SparseOperatorBuilder`` builder.py:520).

    Terms are added as ``builder += coeff, (op, site), (op, site)...``
    where op is a string key ('+', '-', 'n', 'sz', 'x', ...) or an
    explicit 2x2 array. Fermionic 'c'/'cdag' are always Jordan-Wigner
    transformed; calling :meth:`jordan_wigner_transform` additionally
    toggles Z-strings onto '+'/'-' (the reference's convention where
    those denote fermionic modes)."""

    def __init__(self, terms=(), hilbert_space=None, dtype=None,
                 jordan_wigner=False, pauli_decompose=False,
                 atol=1e-12):
        self._sites_used = set()
        self._hilbert_space = hilbert_space
        self._terms_raw = {}
        self._terms_final = None
        self._transform_jordan_wigner = jordan_wigner
        self._transform_pauli_decompose = pauli_decompose
        self._atol = atol
        self._dtype = dtype
        self._coupling_maps = {}
        self._cache = {}
        for term in terms:
            self.add_term(*term)

    # -- hilbert space / registers ------------------------------------------

    @property
    def sites_used(self):
        """Sorted tuple of sites seen so far (reference
        ``sites_used`` builder.py:586)."""
        try:
            return tuple(sorted(self._sites_used))
        except TypeError:
            return tuple(sorted(self._sites_used, key=str))

    @property
    def hilbert_space(self):
        """The Hilbert space, created from the sites seen so far if
        not supplied at construction (reference builder.py:591)."""
        if self._hilbert_space is None:
            self._hilbert_space = HilbertSpace(self.sites_used)
        return self._hilbert_space

    @hilbert_space.setter
    def hilbert_space(self, hs):
        self._hilbert_space = hs

    @property
    def nsites(self):
        return self.hilbert_space.nsites

    def site_to_reg(self, site):
        """Register / linear index of ``site``."""
        return self.hilbert_space.site_to_reg(site)

    def reg_to_site(self, reg):
        return self.hilbert_space.reg_to_site(reg)

    # -- term management ----------------------------------------------------

    def add_term(self, *args):
        """``add_term(coeff, (op, site), ...)`` or
        ``add_term((op, site), ...)`` with coeff 1."""
        if not args:
            raise ValueError("empty term")
        if isinstance(args[0], (int, float, complex, np.number)):
            coeff, ops = args[0], args[1:]
        else:
            coeff, ops = 1.0, args
        raw = []
        for (op, site) in ops:
            if isinstance(op, str):
                if op not in _OP2 and op not in _FERMI_OPS:
                    raise ValueError(f"unknown operator {op!r}")
                raw.append((op, site))
            else:
                raw.append((_op_key(np.asarray(op)), site))
            self._sites_used.add(site)
        key = tuple(raw)
        self._terms_raw[key] = self._terms_raw.get(key, 0.0) + coeff
        if self._terms_raw[key] == 0:
            del self._terms_raw[key]
        self._reset_caches()
        return self

    def __iadd__(self, term):
        self.add_term(*term)
        return self

    def __isub__(self, term):
        if isinstance(term[0], (int, float, complex, np.number)):
            self.add_term(-term[0], *term[1:])
        else:
            self.add_term(-1.0, *term)
        return self

    def _reset_caches(self):
        self._cache.clear()
        self._coupling_maps.clear()
        self._terms_final = None

    @property
    def terms_raw(self):
        """Raw terms as added, as (coeff, ops) pairs (reference
        builder.py:613)."""
        return tuple(
            (coeff, ops) for ops, coeff in self._terms_raw.items()
        )

    # -- transforms ---------------------------------------------------------

    def jordan_wigner_transform(self, value=None):
        """Toggle prepending pauli Z strings to all '+'/'-' (and
        always to 'c'/'cdag') operators (reference builder.py:773)."""
        if value is None:
            value = not self._transform_jordan_wigner
        self._transform_jordan_wigner = bool(value)
        self._reset_caches()

    def pauli_decompose(self, value=None, atol=None, use_zx=False):
        """Toggle decomposing all terms into Pauli strings (reference
        builder.py:800)."""
        if value is None:
            value = not self._transform_pauli_decompose
        self._transform_pauli_decompose = (
            "zx" if (value and use_zx) else bool(value)
        )
        if atol is not None:
            self._atol = atol
        self._reset_caches()

    def _get_terms_final(self):
        """Processed terms: JW expansion, same-site merging, optional
        Pauli decomposition; keyed by ((matkey, site), ...)."""
        if self._terms_final is not None:
            return self._terms_final

        reg = self.site_to_reg
        final = {}

        def accumulate(coeff, ops):
            # merge multiple ops on the same site by matrix product
            by_site = {}
            for (op, site) in ops:
                M = _MAT_FROM_KEY[op] if isinstance(op, tuple) \
                    else _OP2[op]
                if site in by_site:
                    by_site[site] = by_site[site] @ M
                else:
                    by_site[site] = M
            key = tuple(
                (_op_key(by_site[s]), s)
                for s in sorted(by_site, key=reg)
            )
            final[key] = final.get(key, 0.0) + coeff
            if abs(final[key]) < self._atol:
                del final[key]

        for ops, coeff in self._terms_raw.items():
            jw = self._transform_jordan_wigner
            expanded = []
            for (op, site) in ops:
                isferm = op in _FERMI_OPS
                israise = op in ("cdag",) or (jw and op == "+")
                islower = op in ("c",) or (jw and op == "-")
                if isferm or (jw and op in ("+", "-")):
                    # prepend Z string over lower registers
                    r = reg(site)
                    for r2 in range(r):
                        expanded.append(("Z", self.reg_to_site(r2)))
                    expanded.append(
                        ("+", site) if israise else ("-", site)
                    )
                else:
                    expanded.append((op, site))
            # collapse repeated Z's (Z^2 = I) within the string,
            # preserving operator order otherwise
            zcount = collections.Counter(
                s for (o, s) in expanded if o == "Z"
            )
            seen_z = set()
            collapsed = []
            for (o, s) in expanded:
                if o == "Z":
                    if zcount[s] % 2 == 1 and s not in seen_z:
                        collapsed.append((o, s))
                        seen_z.add(s)
                else:
                    collapsed.append((o, s))
            accumulate(coeff, collapsed)

        if self._transform_pauli_decompose:
            use_zx = self._transform_pauli_decompose == "zx"
            final = _pauli_decompose_terms(
                final, atol=self._atol, use_zx=use_zx
            )

        self._terms_final = final
        return final

    @property
    def terms(self):
        """The processed terms as (coeff, ops) pairs (reference
        builder.py:668)."""
        return tuple(
            (coeff, ops)
            for ops, coeff in self._get_terms_final().items()
        )

    @property
    def nterms(self):
        return len(self._get_terms_final())

    @property
    def locality(self):
        return max(
            (len(ops) for ops in self._get_terms_final()), default=0
        )

    @property
    def iscomplex(self):
        """Whether any processed term has complex entries (reference
        builder.py:688)."""
        for ops, coeff in self._get_terms_final().items():
            if np.iscomplexobj(coeff) and abs(complex(coeff).imag) > 0:
                return True
            for opk, _ in ops:
                M = _MAT_FROM_KEY[opk]
                if np.abs(M.imag).max() > 0:
                    return True
        return False

    def get_dtype(self, dtype=None):
        """The numpy dtype the operator should use (reference
        builder.py:835)."""
        if dtype is None:
            dtype = self._dtype
        if dtype is not None:
            return np.dtype(dtype)
        return np.dtype(complex) if self.iscomplex else \
            np.dtype(float)

    def show(self, filler="."):
        """Print an ascii representation of the processed terms
        (reference builder.py:826)."""
        print(self)
        for ops, coeff in self._get_terms_final().items():
            s = [f"{filler} "] * self.nsites
            for opk, site in ops:
                name = _KEY_TO_NAME.get(opk, "?")
                s[self.site_to_reg(site)] = f"{name:<2}"
            print("".join(s), f"{coeff:+}")

    # -- coupling maps ------------------------------------------------------

    def _get_hs(self):
        return self.hilbert_space

    def build_coupling_map(self):
        """For every term: (sites, flip_mask, amp 2x2 tables).

        Acting on a bit configuration, each term maps it to exactly one
        configuration (or annihilates it):
        ``new_bits = bits XOR flip``; the amplitude is the product over
        the term's sites of ``M[new_bit, old_bit]``."""
        out = []
        reg = self.site_to_reg
        for ops, coeff in self._get_terms_final().items():
            sites = []
            mats = []
            flip = 0
            for (opk, site) in ops:
                M = _MAT_FROM_KEY[opk]
                r = reg(site)
                sites.append(r)
                mats.append(M)
                # a 2x2 op participates in a single-output map iff each
                # column has at most one nonzero; flip if offdiagonal
                offdiag = (abs(M[0, 1]) > 0 or abs(M[1, 0]) > 0)
                diag = (abs(M[0, 0]) > 0 or abs(M[1, 1]) > 0)
                if offdiag and diag:
                    raise ValueError(
                        "operator mixes diagonal and off-diagonal "
                        "action; use pauli_decompose() first"
                    )
                if offdiag:
                    flip |= 1 << r
            out.append((coeff, tuple(sites), flip, tuple(mats)))
        return out

    def get_coupling_map(self, dtype=None):
        """Build and cache the coupling map (reference
        builder.py:853)."""
        key = self.get_dtype(dtype)
        if key not in self._coupling_maps:
            self._coupling_maps[key] = self.build_coupling_map()
        return self._coupling_maps[key]

    def flatconfig_coupling(self, flatconfig, dtype=None):
        """All configurations coupled to ``flatconfig`` with their
        coefficients (reference builder.py:881) — for VMC local
        energies."""
        flatconfig = np.asarray(flatconfig, dtype=np.uint8)
        dtype = self.get_dtype(dtype)
        out = {}
        for coeff, sites, flip, mats in self.get_coupling_map(dtype):
            new = flatconfig.copy()
            amp = complex(coeff)
            for r, M in zip(sites, mats):
                old_b = int(flatconfig[r])
                new_b = old_b ^ ((flip >> r) & 1)
                amp *= complex(M[new_b, old_b])
                new[r] = new_b
            if amp == 0:
                continue
            k = new.tobytes()
            if k in out:
                out[k] = (out[k][0], out[k][1] + amp)
            else:
                out[k] = (new, amp)
        if not out:
            return (np.zeros((0, flatconfig.size), dtype=np.uint8),
                    np.zeros(0, dtype=dtype))
        configs = np.stack([v[0] for v in out.values()])
        coeffs = np.array([v[1] for v in out.values()])
        if not np.issubdtype(dtype, np.complexfloating):
            coeffs = coeffs.real
        return configs, coeffs.astype(dtype)

    def config_coupling(self, config, dtype=None):
        """Configurations (as site dicts) coupled to ``config``
        (reference builder.py:909)."""
        hs = self.hilbert_space
        fc = hs.config_to_flatconfig(config)
        bjs, cijs = self.flatconfig_coupling(fc, dtype=dtype)
        return [hs.flatconfig_to_config(b) for b in bjs], list(cijs)

    def evaluate_exact_flatconfigs(self, fn_amplitude, progbar=False):
        """<psi|H|psi>/<psi|psi> for a wavefunction given as
        ``fn_amplitude(flatconfig) -> amplitude`` (reference
        builder.py:933)."""
        hs = self.hilbert_space
        O, p = 0.0, 0.0
        for r in range(hs.size):
            fc = hs.rank_to_flatconfig(r)
            xpsi = fn_amplitude(fc)
            if not xpsi:
                continue
            pi = abs(xpsi) ** 2
            p += pi
            Oloc = 0.0
            for fy, hxy in zip(*self.flatconfig_coupling(fc)):
                Oloc = Oloc + hxy * fn_amplitude(fy) / xpsi
            O += Oloc * pi
        return O / p

    def evaluate_exact_configs(self, fn_amplitude, progbar=False):
        """Like :meth:`evaluate_exact_flatconfigs` but with dict
        configs (reference builder.py:969)."""
        hs = self.hilbert_space
        O, p = 0.0, 0.0
        for r in range(hs.size):
            config = hs.rank_to_config(r)
            xpsi = fn_amplitude(config)
            if not xpsi:
                continue
            pi = abs(xpsi) ** 2
            p += pi
            Oloc = 0.0
            cys, hxys = self.config_coupling(config)
            for cy, hxy in zip(cys, hxys):
                Oloc = Oloc + hxy * fn_amplitude(cy) / xpsi
            O += Oloc * pi
        return O / p

    # -- matrix building ----------------------------------------------------

    def build_coo_data(self):
        """Vectorized COO construction over all sector configs
        (replaces the numba ``configcore`` builders)."""
        hs = self._get_hs()
        configs = hs.get_configs()
        bits = hs.config_to_bits(configs)  # (D, nsites)
        rows_all, cols_all, vals_all = [], [], []
        for coeff, sites, flip, mats in self.build_coupling_map():
            new_configs = configs ^ flip
            amp = np.full(configs.shape, complex(coeff))
            for site, M in zip(sites, mats):
                old_b = bits[:, site]
                new_b = old_b ^ ((flip >> site) & 1)
                amp = amp * np.asarray(M)[new_b, old_b]
            nz = amp != 0
            new_idx = hs.rank(new_configs[nz])
            valid = new_idx >= 0
            rows_all.append(new_idx[valid])
            cols_all.append(np.arange(configs.size)[nz][valid])
            vals_all.append(amp[nz][valid])
        if rows_all:
            rows = np.concatenate(rows_all)
            cols = np.concatenate(cols_all)
            vals = np.concatenate(vals_all)
        else:
            rows = cols = np.zeros(0, dtype=np.int64)
            vals = np.zeros(0, dtype=complex)
        return rows, cols, vals, hs.size

    def build_sparse_matrix(self, stype="csr"):
        """Host scipy sparse matrix (reference
        ``build_sparse_matrix``)."""
        import scipy.sparse as sp

        rows, cols, vals, D = self.build_coo_data()
        if np.allclose(vals.imag, 0):
            vals = vals.real
        return sp.coo_matrix(
            (vals, (rows, cols)), shape=(D, D)
        ).asformat(stype)

    def build_dense(self, device=None):
        """The dense sector matrix as a tensor on ``device`` (the GPU by
        default)."""
        from ..ops.backend import resolve_device, to_device

        return to_device(self.build_sparse_matrix().toarray(),
                         device=resolve_device(device))

    def build_matrix_ikron(self, device=None, **ikron_opts):
        """The dense matrix of the full space assembled term by term with
        ``ikron`` (reference ``build_matrix_ikron`` builder.py:1706), a
        tensor on ``device`` (the GPU by default)."""
        from ..core import ikron
        from ..ops.backend import resolve_device

        device = resolve_device(device)
        n = self.nsites
        dims = [2] * n
        out = 0
        for ops, coeff in self._get_terms_final().items():
            mats = [np.asarray(_MAT_FROM_KEY[opk]) for opk, _ in ops]
            inds = [self.site_to_reg(s) for _, s in ops]
            out = out + coeff * ikron(mats, dims, inds, device=device,
                                      **ikron_opts)
        return out

    def build_local_terms(self, dtype=None):
        """Terms merged by site support into dense local arrays:
        ``{(sites...): array}`` (reference ``build_local_terms``
        builder.py:1312)."""
        dtype = self.get_dtype(dtype)
        out = {}
        for ops, coeff in self._get_terms_final().items():
            sites = tuple(s for _, s in ops)
            M = functools.reduce(
                np.kron, [_MAT_FROM_KEY[opk] for opk, _ in ops]
            )
            acc = out.get(sites)
            out[sites] = coeff * M if acc is None else acc + coeff * M
        if not np.issubdtype(dtype, np.complexfloating):
            out = {k: v.real.astype(dtype) for k, v in out.items()}
        else:
            out = {k: v.astype(dtype) for k, v in out.items()}
        return out

    def build_sparse_ham(self, dtype=None, device=None):
        """The sector matrix as an ELL
        :class:`~quimb_torch.core.SparseHam` on ``device`` (the GPU by
        default), in ``dtype`` (complex128 unless given, as quimb_tpu's)."""
        from ..core import SparseHam
        from ..ops.backend import to_torch_dtype

        if dtype is not None:
            dtype = to_torch_dtype(dtype)
        return SparseHam(self.build_sparse_matrix(), dtype=dtype,
                         device=device)

    def build_coupled_ham(self, dtype=None, device=None):
        """The sector operator applied on the device without its matrix
        (reference ``configcore.matvec_nosymm/z2/u1/u1u1``
        configcore.py:288-:737): the configurations, the diagonal and the
        coupling tables on ``device`` (the GPU by default), one
        :class:`~quimb_torch.operator.configdevice.CoupledHam` for each
        dtype and device."""
        from ..ops.backend import resolve_device
        from .configdevice import CoupledHam

        dtype = self.get_dtype(dtype)
        device = resolve_device(device)
        key = ("coupled_ham", np.dtype(dtype).name, str(device))
        if key not in self._cache:
            self._cache[key] = CoupledHam(
                self.get_coupling_map(dtype), self.hilbert_space,
                dtype=np.dtype(dtype).name, device=device)
        return self._cache[key]

    def matvec(self, x, dtype=None):
        """The operator times the sector vector ``x``, on ``x``'s device,
        from the coupling tables: no matrix is built (reference
        ``SparseOperatorBuilder.matvec`` builder.py:1173)."""
        return self.build_coupled_ham(dtype, device=x.device) @ x

    def aslinearoperator(self):
        import scipy.sparse.linalg as spla

        H = self.build_sparse_matrix()
        return spla.aslinearoperator(H)

    # -- MPO via greedy state machine ----------------------------------------

    def build_state_machine_greedy(self, atol=1e-12):
        """Build a finite-state machine for the MPO: terms are merged
        greedily by identical *futures* at every bond, which reaches
        the standard optimal bond dimensions (reference
        ``build_state_machine_greedy`` builder.py:1377).

        Returns
        -------
        transitions : list[dict]
            For each register r, a dict ``{(state_in, state_out):
            2x2 array}``; state 0 is 'ready' (identity before the
            term), state 1 is 'done' (identity after).
        nstates : list[int]
            The number of states at each bond (len ``nsites + 1``).
        """
        n = self.nsites
        reg = self.site_to_reg
        # each term: {reg: matrix}, coeff attached to its FIRST op so
        # futures (which determine state sharing) are coefficient-free
        terms = []
        for ops, coeff in self._get_terms_final().items():
            if abs(coeff) < atol:
                continue
            byreg = {reg(s): _MAT_FROM_KEY[opk] for opk, s in ops}
            regs = sorted(byreg)
            byreg[regs[0]] = byreg[regs[0]] * coeff
            terms.append((regs, byreg))

        READY, DONE = 0, 1

        def future_key(byreg, regs, r):
            return tuple(
                (rr, _op_key(byreg[rr])) for rr in regs if rr > r
            )

        # states per bond: 0=ready, 1=done, then one per distinct
        # future of the crossing terms
        bond_states = []
        for b in range(n + 1):
            states = {"ready": READY, "done": DONE}
            for regs, byreg in terms:
                if regs[0] <= b - 1 and regs[-1] > b - 1:
                    fk = future_key(byreg, regs, b - 1)
                    if fk and fk not in states:
                        states[fk] = len(states)
            bond_states.append(states)

        I2 = np.eye(2, dtype=complex)
        transitions = [dict() for _ in range(n)]

        def add(r, si, so, M):
            key = (si, so)
            if key in transitions[r]:
                transitions[r][key] = transitions[r][key] + M
            else:
                transitions[r][key] = np.asarray(M, dtype=complex)

        for r in range(n):
            left, right = bond_states[r], bond_states[r + 1]
            # pass-through identities
            add(r, READY, READY, I2)
            add(r, DONE, DONE, I2)
            for regs, byreg in terms:
                lo, hi = regs[0], regs[-1]
                if r < lo or r > hi:
                    continue
                si = READY if r == lo else left[
                    future_key(byreg, regs, r - 1)
                ]
                so = DONE if r == hi else right[
                    future_key(byreg, regs, r)
                ]
                M = byreg.get(r, I2)
                if si == READY:
                    # term-start edges: terms with a shared future
                    # state legitimately SUM here (the automaton sums
                    # over paths), e.g. c1*Sx + c2*Sy -> shared Sz tail
                    add(r, si, so, M)
                else:
                    # pass-through edges: M is a function of the state
                    # alone, so terms sharing both endpoint states
                    # must not double-count — set, don't accumulate
                    transitions[r][(si, so)] = np.asarray(
                        M, dtype=complex
                    )
        nstates = [len(s) for s in bond_states]
        return transitions, nstates

    def draw_state_machine(self, **kwargs):
        """Print a text rendering of the MPO state machine (reference
        ``draw_state_machine`` builder.py:1541 draws with
        matplotlib); returns its transitions."""
        transitions, nstates = self.build_state_machine_greedy()
        for r, trans in enumerate(transitions):
            print(f"reg {r}: {nstates[r]} -> {nstates[r + 1]} states")
            for (si, so), M in sorted(trans.items()):
                name = _KEY_TO_NAME.get(_op_key(M), "op")
                print(f"  {si} --{name}--> {so}")
        return transitions

    def build_mpo(self, L=None, dtype=None, device=None, **mpo_opts):
        """An MPO of the operator via the greedy FSM (reference
        ``build_mpo`` builder.py:1632), compressed at cutoff 1e-14, its
        tensors on ``device`` (the GPU by default). Its dtype is
        complex64 for a complex operator and the default dtype otherwise,
        unless given, as quimb_tpu's."""
        from ..config import get_default_dtype
        from ..ops.backend import resolve_device, to_device, to_torch_dtype
        from ..tensor.tn1d.core import MatrixProductOperator

        n = self.nsites
        if L is not None and L != n:
            raise ValueError("L must equal the number of sites")
        dtype = to_torch_dtype(dtype or (
            "complex64" if self.iscomplex else get_default_dtype()))
        device = resolve_device(device)
        transitions, nstates = self.build_state_machine_greedy()
        arrays = []
        for r in range(n):
            W = np.zeros((nstates[r], nstates[r + 1], 2, 2), dtype=complex)
            for (si, so), M in transitions[r].items():
                W[si, so] += np.asarray(M)
            arrays.append(W)
        # boundary vectors: start in 'ready', end in 'done'
        arrays[0] = arrays[0][0]           # (wr, u, d)
        arrays[-1] = arrays[-1][:, 1]      # (wl, u, d)
        if not dtype.is_complex:
            arrays = [a.real for a in arrays]
        mpo = MatrixProductOperator(
            [to_device(a, device=device, dtype=dtype) for a in arrays],
            shape="lrud", **mpo_opts)
        mpo.compress(cutoff=1e-14)
        return mpo

    def build_local_ham(self, L=None, **kwargs):
        """Two-site LocalHam1D (nearest-neighbour terms only)."""
        from ..tensor.tn1d.tebd import LocalHam1D

        L = L or self.nsites
        H2 = {}
        H1 = {}
        for ops, coeff in self._get_terms_final().items():
            sites = sorted(set(self.site_to_reg(s) for _, s in ops))
            if len(sites) == 1:
                (s,) = sites
                M = coeff * functools.reduce(
                    lambda a, b: a @ b,
                    [_MAT_FROM_KEY[o] for o, _ in ops],
                )
                H1[s] = H1.get(s, 0) + M
            elif len(sites) == 2 and sites[1] - sites[0] == 1:
                a, b = sites
                Ma = np.eye(2, dtype=complex)
                Mb = np.eye(2, dtype=complex)
                for (opk, s) in ops:
                    if self.site_to_reg(s) == a:
                        Ma = Ma @ _MAT_FROM_KEY[opk]
                    else:
                        Mb = Mb @ _MAT_FROM_KEY[opk]
                key = (a, b)
                H2[key] = H2.get(key, 0) + coeff * np.kron(Ma, Mb)
            else:
                raise ValueError(
                    "local ham needs nearest-neighbour terms only"
                )
        return LocalHam1D(L, H2, H1 if H1 else None, **kwargs)

    def __repr__(self):
        return (
            f"<SparseOperatorBuilder(nsites={self.nsites}, "
            f"nterms={self.nterms}, locality={self.locality})>"
        )


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

_KEY_FROM_MAT = {}
_MAT_FROM_KEY = {}
_KEY_TO_NAME = {}


def get_mat(op, dtype=None):
    """The dense 2x2 matrix of a named single-site operator (reference
    ``get_mat`` operator/builder.py:50)."""
    M = _op_matrix(op)
    if dtype is not None:
        M = M.astype(dtype)
    elif not np.iscomplexobj(M) or np.allclose(M.imag, 0):
        M = M.real.astype(np.float64) if np.allclose(M.imag, 0) \
            else M
    return M


def _op_matrix(op):
    if isinstance(op, str):
        if op not in _OP2:
            raise ValueError(f"unknown operator {op!r}")
        return _OP2[op]
    return np.asarray(op, dtype=complex)


def _op_key(M):
    """Canonical hashable key for a 2x2 matrix."""
    key = tuple(np.round(np.asarray(M, dtype=complex).ravel(), 14))
    _MAT_FROM_KEY.setdefault(key, np.asarray(M, dtype=complex))
    return key


# make string keys also resolvable, remember display names
for _name, _M in _OP2.items():
    _k = _op_key(_M)
    _MAT_FROM_KEY[_k] = _M
    _KEY_TO_NAME.setdefault(_k, _name)


_PAULIS = {
    "I": np.eye(2, dtype=complex),
    "X": _OP2["X"],
    "Y": _OP2["Y"],
    "Z": _OP2["Z"],
}


def _pauli_decompose_terms(terms, atol=1e-12, use_zx=False):
    """Expand every term into Pauli strings: each 2x2 factor is
    decomposed as ``M = sum_P tr(P M)/2 P`` (reference
    ``pauli_decompose`` builder.py:269). With ``use_zx`` the real
    operator ``ZX = iY`` replaces Y."""
    out = {}
    ZX = _PAULIS["Z"] @ _PAULIS["X"]
    for ops, coeff in terms.items():
        factors = []
        for opk, site in ops:
            M = _MAT_FROM_KEY[opk]
            opts = []
            for name, P in _PAULIS.items():
                c = np.trace(P.conj().T @ M) / 2
                if abs(c) > atol:
                    if use_zx and name == "Y":
                        # Y = -i ZX
                        opts.append((c * (-1j), _op_key(ZX), site))
                    else:
                        opts.append((c, _op_key(P), site))
            factors.append(opts)
        for combo in itertools.product(*factors):
            c = coeff
            sops = []
            for (ci, pk, site) in combo:
                c = c * ci
                if pk != _op_key(_PAULIS["I"]):
                    sops.append((pk, site))
            if abs(c) < atol:
                continue
            key = tuple(sops)
            out[key] = out.get(key, 0.0) + c
            if abs(out[key]) < atol:
                del out[key]
    return out


def add_mpo(A, B):
    """The direct-sum addition of two MPOs (their bond dimensions add)."""
    import torch

    from ..tensor.tn1d.core import MatrixProductOperator

    L = A.L
    site_arrays = []
    for i in range(L):
        aa = _mpo_site_uniform(A, i)
        ab = _mpo_site_uniform(B, i)
        if i == 0:
            new = torch.cat([aa, ab], dim=1)[0]
        elif i == L - 1:
            new = torch.cat([aa, ab], dim=0)[:, 0]
        else:
            wl = aa.shape[0] + ab.shape[0]
            wr = aa.shape[1] + ab.shape[1]
            d = aa.shape[2]
            new = torch.zeros((wl, wr, d, d), device=aa.device,
                              dtype=torch.promote_types(aa.dtype, ab.dtype))
            new[:aa.shape[0], :aa.shape[1]] = aa
            new[aa.shape[0]:, aa.shape[1]:] = ab
        site_arrays.append(new)
    # boundary layouts: first (wr, u, d), last (wl, u, d)
    return MatrixProductOperator(
        site_arrays, shape="lrud",
        upper_ind_id=A.upper_ind_id, lower_ind_id=A.lower_ind_id,
        site_tag_id=A.site_tag_id,
    )


def _mpo_site_uniform(mpo, i):
    """An MPO site array as (wl, wr, u, d) with padded boundaries."""
    t = mpo[mpo.site_tag(i)]
    u, d = mpo.upper_ind(i), mpo.lower_ind(i)
    L = mpo.L
    lshared = [ix for ix in t.inds
               if i > 0 and ix in mpo[mpo.site_tag(i - 1)].inds]
    rshared = [ix for ix in t.inds
               if i < L - 1 and ix in mpo[mpo.site_tag(i + 1)].inds]
    arr = t.transpose(*(lshared + rshared + [u, d])).data
    if not lshared:
        arr = arr[None, ...]
    if not rshared:
        arr = arr[:, None, ...]
    return arr
