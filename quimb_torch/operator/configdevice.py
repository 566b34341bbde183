"""A second-quantised operator applied to a vector of one symmetry sector on
the device, without its matrix.

Port of ``quimb_tpu/operator/configdevice.py`` (``CoupledHam``), quimb_tpu's
replacement for the reference's numba configuration kernels
(``quimb/operator/configcore.py``: ranking :112-:236, the symmetric matvecs
:288-:737). It computes what quimb_tpu's computes,

    y[r] = sum_t amp_t(r) * x[rank(config[r] ^ flip_t)],

masked to the sector, but is built for the card:

- each sector configuration is one ``int64`` word on the device, site
  (register) 0 the least significant bit, rank-ordered like the vector
  (quimb_tpu packs two 31-bit ``int32`` words, as its TPU has no 64-bit
  integers);
- the terms are merged by their sites and flip mask: a group's amplitude
  depends only on the row's bits at its sites, so it is a table of
  ``2**k`` entries for ``k`` sites, summed over its terms on the host (the
  complex product of each term's factors first, then the real part for a
  real operator, as quimb_tpu takes it). Entries whose move leaves the
  sector are zero, so no mask is needed at apply time; a group whose table
  is zero is dropped;
- the groups that flip no bit add up to one diagonal, made once on the
  device at build time;
- the other groups of one arity are applied together, in chunks of
  ``(T, D)`` bounded by :attr:`CoupledHam.CHUNK_ELEMENTS`: so the launches
  of a matvec scale with the chunks and the ranking windows, not with the
  terms (quimb_tpu scans the terms with ``lax.scan`` and the bits with
  ``fori_loop``);
- the combinatorial rank of a coupled configuration (U1, and each half of
  U1U1) is read from tables of :attr:`CoupledHam.RANK_BITS`-bit windows:
  the entry of a window's value and of the count of set bits below the
  window is the window's share of the rank, so a 24-site rank takes two
  lookups instead of 24 steps; Z2 and unsymmetric ranks are bit shifts;
- a block of columns ``(D, m)`` gathers its rows in one pass (quimb_tpu
  ``vmap``s the matvec over them).

The limits are quimb_tpu's: at most 62 sites, and beyond 31 only a U1 or
U1U1 sector.
"""

import math

import numpy as np
import torch

from ..ops.backend import resolve_device, to_device, to_torch_dtype
from ..tracing import spanned
from .hilbertspace import _binom_table

__all__ = ["CoupledHam"]


def _preserves(symmetry, na, sites, nb_bits, ob_bits):
    """Whether the move ``ob_bits -> nb_bits`` on ``sites`` keeps a
    configuration in its sector."""
    if symmetry is None:
        return True
    delta = [n - o for n, o in zip(nb_bits, ob_bits)]
    if symmetry == "Z2":
        return sum(delta) % 2 == 0
    if symmetry == "U1":
        return sum(delta) == 0
    da = sum(d for s, d in zip(sites, delta) if s < na)
    return da == 0 and sum(delta) == 0


def _rank_windows(nbits, width):
    """(shift within the segment, width) of each window of a segment of
    ``nbits`` bits."""
    return [(off, min(width, nbits - off)) for off in range(0, nbits, width)]


class CoupledHam:
    """A symmetry-sector operator held as coupling tables on the device and
    applied by gather (see the module's docstring).

    Build it with :meth:`SparseOperatorBuilder.build_coupled_ham`. It
    behaves like :class:`~quimb_torch.core.SparseHam` (``@``, ``matvec``,
    ``shape``, ``dtype``, ``device``, ``to_dense``), but the matrix never
    exists: the device holds the D configurations, the diagonal, and
    tables of size independent of D.

    Parameters
    ----------
    coupling_map : sequence
        ``(coeff, sites, flip, mats)`` per term: register indices, the XOR
        mask of the bits it flips, and each site's 2x2 matrix, as
        :meth:`SparseOperatorBuilder.build_coupling_map` gives them.
    hilbert_space : HilbertSpace
    dtype : torch dtype or name
    device : device, optional
        The GPU unless given.
    """

    #: the most elements of one ``(T, D)`` (or ``(T, D, m)``) chunk of
    #: coupled configurations; six int64 temporaries of this size live at
    #: once
    CHUNK_ELEMENTS = 2**26
    #: the bits of a configuration one ranking table covers
    RANK_BITS = 12

    def __init__(self, coupling_map, hilbert_space, dtype="float64",
                 device=None):
        hs = hilbert_space
        n = hs.nsites
        if n > 62:
            raise NotImplementedError(
                "configs are packed in one int64 word: nsites <= 62")
        if n > 31 and hs.symmetry not in ("U1", "U1U1"):
            raise NotImplementedError(
                "nsites > 31 needs a rankable sector (U1/U1U1): the "
                "nosymm/Z2 spaces are 2**nsites-sized and cannot be "
                "stored anyway")
        self.device = resolve_device(device)
        self.dtype = to_torch_dtype(dtype)
        self.nsites = n
        self.symmetry = hs.symmetry
        self.sector = hs.sector
        D = hs.size
        self.shape = (D, D)
        self._na = n // 2 if self.symmetry == "U1U1" else None
        self.configs = to_device(hs.get_configs().astype(np.int64),
                                 device=self.device)

        # merge the terms by (sites, flip) into amplitude tables
        const = 0.0
        tables = {}
        self.nterms_by_arity = {}
        for coeff, sites, flip, mats in coupling_map:
            k = len(sites)
            self.nterms_by_arity[k] = self.nterms_by_arity.get(k, 0) + 1
            if k == 0:
                const += complex(coeff)
                continue
            order = np.argsort(sites)
            ssites = tuple(int(sites[a]) for a in order)
            smats = [np.asarray(mats[a], complex) for a in order]
            flip = int(flip)
            table = tables.setdefault((ssites, flip),
                                      np.zeros(2**k, complex))
            for p in range(2**k):
                nb = [(p >> a) & 1 for a in range(k)]
                ob = [b ^ ((flip >> s) & 1) for b, s in zip(nb, ssites)]
                if not _preserves(self.symmetry, self._na, ssites, nb, ob):
                    continue
                amp = complex(coeff)
                for M, i, j in zip(smats, nb, ob):
                    amp *= M[i, j]
                table[p] += amp
        tables = {key: t for key, t in tables.items() if np.any(t != 0)}
        iscomplex = self.dtype.is_complex
        real = all(np.allclose(t.imag, 0) for t in tables.values()) and (
            np.isclose(complex(const).imag, 0))
        rdtype = torch.empty(0, dtype=self.dtype).real.dtype
        self._table_dtype = rdtype if real else (
            self.dtype if iscomplex else torch.complex128
            if rdtype == torch.float64 else torch.complex64)
        self.const_shift = complex(const) if iscomplex else complex(
            const).real

        diag_groups, groups = {}, {}
        for (sites, flip), t in tables.items():
            into = diag_groups if flip == 0 else groups
            into.setdefault(len(sites), []).append((sites, flip, t))
        self.groups = tuple(self._pack(k, groups[k]) for k in sorted(groups))
        self.ngroups = sum(len(g) for g in groups.values())
        self._rank_tables()
        self.diag = self._make_diag(
            [self._pack(k, diag_groups[k]) for k in sorted(diag_groups)])

    def _pack(self, k, entries):
        """One arity's groups as device tensors: sites (G, k) less their
        sorted position (the shifts that bring site a's bit to bit a),
        flips (G, 1) and tables (G, 2**k)."""
        sites = np.asarray([e[0] for e in entries], np.int64)
        tables = np.stack([e[2] for e in entries])
        if not self._table_dtype.is_complex:
            tables = tables.real
        return (to_device(sites - np.arange(k), device=self.device),
                to_device(np.asarray([[e[1]] for e in entries], np.int64),
                          device=self.device),
                to_device(tables, device=self.device,
                          dtype=self._table_dtype),
                k)

    def _rank_tables(self):
        """The device tables of the combinatorial rank: per segment (the
        whole register for U1, each half for U1U1) and per window of
        RANK_BITS bits, ``table[c, v]``, the window's share of the rank for
        the value ``v`` with ``c`` set bits below the window, and the
        popcount of a window's value."""
        sym, n = self.symmetry, self.nsites
        if sym == "U1":
            segments = [(0, n, 1)]
        elif sym == "U1U1":
            na = self._na
            segments = [(0, na, 1),
                        (na, n - na, math.comb(na, int(self.sector[0])))]
        else:
            self._segments = None
            return
        width = min(self.RANK_BITS, max(nb for _, nb, _ in segments))
        vals = np.arange(2**width, dtype=np.int64)
        bits = (vals[:, None] >> np.arange(width)) & 1
        below = np.cumsum(bits, axis=1)       # set bits up to each bit
        self._pop = to_device(below[:, -1], device=self.device)
        self._segments = []
        for offset, nbits, mult in segments:
            B = _binom_table(nbits)
            windows = []
            for shift, w in _rank_windows(nbits, width):
                pos = shift + np.arange(w)
                tab = np.zeros((nbits + 1, 2**w), np.int64)
                for c in range(nbits + 1):
                    m = np.minimum(c + below[:2**w, :w], nbits)
                    tab[c] = (bits[:2**w, :w] * B[pos, m]).sum(axis=1)
                windows.append((offset + shift, w,
                                to_device(tab.reshape(-1),
                                          device=self.device)))
            self._segments.append((mult, windows))

    def _rank(self, cc):
        """The sector rank of the configurations ``cc`` (any shape); out of
        the sector it is clamped garbage, which a zero amplitude meets."""
        sym = self.symmetry
        if sym is None:
            return cc
        if sym == "Z2":
            return cc >> 1
        top = self.nsites
        r = None
        for mult, windows in self._segments:
            rs, cnt = None, None
            for i, (shift, w, tab) in enumerate(windows):
                v = cc >> shift if shift else cc
                if shift + w < top:
                    v = v & (2**w - 1)
                if cnt is None:
                    rs = tab[v]
                else:
                    rs += tab[cnt * 2**w + v]
                if i + 1 < len(windows):
                    cnt = self._pop[v] if cnt is None else cnt + self._pop[v]
            r = rs if r is None else r + mult * rs
        return r.clamp_(0, self.shape[0] - 1)

    @staticmethod
    def _amp_index(c, shifts, k):
        """The index into a group's table: the row's bits at its k sites,
        site a's bit as bit a."""
        idx = None
        for a in range(k):
            b = (c >> shifts[:, a:a + 1]) & (1 << a)
            idx = b if idx is None else idx + b
        return idx

    def _chunks(self, G, cols):
        T = max(1, self.CHUNK_ELEMENTS // (self.shape[0] * max(cols, 1)))
        return range(0, G, T), T

    def _make_diag(self, packed):
        """The diagonal: the constant plus every group that flips no bit."""
        c = self.configs[None, :]
        diag = torch.full((self.shape[0],), self.const_shift
                          if self._table_dtype.is_complex else
                          complex(self.const_shift).real,
                          dtype=self._table_dtype, device=self.device)
        for shifts, _, tables, k in packed:
            starts, T = self._chunks(shifts.shape[0], 1)
            for s in starts:
                idx = self._amp_index(c, shifts[s:s + T], k)
                diag += tables[s:s + T].gather(1, idx).sum(0)
        return diag

    # -- matvec ---------------------------------------------------------------

    @spanned("sector_matvec")
    def matvec(self, x):
        """``H @ x`` for x (D,) or a block of columns (D, m), in the
        promoted dtype of the operator and ``x``."""
        out_dtype = torch.promote_types(self.dtype, x.dtype)
        x = x.to(out_dtype)
        real_out = not out_dtype.is_complex
        tail = x.shape[1:]
        ones = (1,) * len(tail)
        cols = int(np.prod(tail)) if tail else 1
        diag = self.diag.real if real_out and self.diag.is_complex() \
            else self.diag
        y = diag.to(out_dtype).reshape(-1, *ones) * x
        c = self.configs[None, :]
        D = self.shape[0]
        for shifts, flips, tables, k in self.groups:
            starts, T = self._chunks(shifts.shape[0], cols)
            for s in starts:
                sh, fl, tab = shifts[s:s + T], flips[s:s + T], tables[s:s + T]
                amp = tab.gather(1, self._amp_index(c, sh, k))
                if real_out and amp.is_complex():
                    amp = amp.real
                j = self._rank(c ^ fl)
                xv = x.index_select(0, j.reshape(-1)).reshape(
                    j.shape[0], D, *tail)
                y += (amp.to(out_dtype).reshape(*j.shape, *ones) * xv).sum(0)
        return y

    def __matmul__(self, x):
        if x.ndim == 2 and x.shape[1] == 1:
            return self.matvec(x[:, 0]).reshape(-1, 1)
        return self.matvec(x)

    def to_dense(self):
        """The dense sector matrix (small sectors and tests only)."""
        return self @ torch.eye(self.shape[0], dtype=self.dtype,
                                device=self.device)

    def __repr__(self):
        return (f"CoupledHam(D={self.shape[0]}, nsites={self.nsites}, "
                f"symmetry={self.symmetry}, sector={self.sector}, "
                f"nterms={sum(self.nterms_by_arity.values())}, "
                f"dtype={self.dtype})")
