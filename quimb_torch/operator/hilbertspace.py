"""Hilbert spaces with symmetry sectors.

A copy of ``quimb_tpu/operator/hilbertspace.py`` (pure numpy, copied
rather than imported: importing anything of quimb_tpu imports JAX). It
re-designs the reference's ``quimb/operator/hilbertspace.py``
(``HilbertSpace`` :175, sectors Z2/U1/U1U1 :39-126) and the numba
config-ranking kernels of ``configcore.py`` (:112-:236).

Configurations are bitstrings packed into int64, site (register) 0 the
least significant bit; sector enumeration and ranking run vectorized on
host numpy at setup time. :class:`quimb_torch.operator.configdevice.CoupledHam`
ranks on the device instead.
"""

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=None)
def _binom_table(n):
    """C[k, m] = binomial(k, m) for 0 <= k, m <= n."""
    C = np.zeros((n + 1, n + 1), dtype=np.int64)
    C[:, 0] = 1
    for k in range(1, n + 1):
        for m in range(1, k + 1):
            C[k, m] = C[k - 1, m - 1] + C[k - 1, m]
    return C


def parse_symmetry(symmetry, nsites, sector):
    symmetry = (symmetry or "").upper() if isinstance(symmetry, str) \
        else symmetry
    if not symmetry or symmetry in ("NONE",):
        return None, None
    return symmetry, sector


class HilbertSpace:
    """A space of ``nsites`` qubits/spinless-fermion modes, optionally
    restricted to a symmetry sector:

    - ``symmetry='Z2'``, ``sector`` in {0, 1}: parity of set bits.
    - ``symmetry='U1'``, ``sector=k``: exactly k set bits.
    - ``symmetry='U1U1'``, ``sector=(ka, kb)``: k set bits in each half
      (e.g. spinful fermions).
    """

    def __init__(self, nsites, symmetry=None, sector=None):
        if isinstance(nsites, int):
            self._sites = tuple(range(nsites))
        else:
            # reference signature: a sequence of (hashable) site labels
            try:
                self._sites = tuple(sorted(nsites))
            except TypeError:
                self._sites = tuple(sorted(nsites, key=str))
            nsites = len(self._sites)
        self._nsites = nsites
        self._symmetry, self._sector = parse_symmetry(
            symmetry, nsites, sector
        )
        self._configs = None
        self._rank_lookup = None
        self._site_to_reg = None

    @property
    def nsites(self):
        return self._nsites

    @property
    def symmetry(self):
        return self._symmetry

    @property
    def sector(self):
        return self._sector

    @property
    def sites(self):
        return self._sites

    @classmethod
    def from_edges(cls, edges, order=None):
        """Create from the unique sites in a list of edges (reference
        ``HilbertSpace.from_edges`` hilbertspace.py:361)."""
        sites = set()
        for i, j in edges:
            sites.add(i)
            sites.add(j)
        try:
            sites = sorted(sites)
        except TypeError:
            sites = sorted(sites, key=str)
        hs = cls(sites)
        if order is not None:
            hs.set_ordering(order)
        return hs

    def set_ordering(self, order):
        """Reorder the sites (register assignment); resets caches
        (reference ``set_ordering`` hilbertspace.py:323)."""
        if order is None:
            try:
                self._sites = tuple(sorted(self._sites))
            except TypeError:
                self._sites = tuple(sorted(self._sites, key=str))
        else:
            order = tuple(order)
            if set(order) != set(self._sites):
                raise ValueError("order must be a permutation of sites")
            self._sites = order
        self._configs = None
        self._rank_lookup = None
        self._site_to_reg = None

    # -- site/register mapping ---------------------------------------------

    def _get_site_to_reg(self):
        if self._site_to_reg is None:
            self._site_to_reg = {
                s: r for r, s in enumerate(self._sites)
            }
        return self._site_to_reg

    def site_to_reg(self, site):
        """Linear register index of ``site`` (reference
        ``site_to_reg``)."""
        return self._get_site_to_reg()[site]

    def reg_to_site(self, reg):
        return self._sites[reg]

    def has_site(self, site):
        return site in self._get_site_to_reg()

    def site_size(self, site=None):
        """Local dimension (always 2: qubits / spinless modes)."""
        return 2

    def get_sizes(self):
        return (2,) * self._nsites

    @property
    def sizes(self):
        return self.get_sizes()

    def get_strides(self):
        """Mixed-radix strides, site 0 the least significant (the bit
        convention used throughout)."""
        return tuple(2**r for r in range(self._nsites))

    @property
    def strides(self):
        return self.get_strides()

    def get_pascal_table(self):
        """Cumulative binomial table used for U1 combinatorial ranking
        (reference ``get_pascal_table`` hilbertspace.py:476)."""
        return _binom_table(self._nsites)

    def get_sector_numba(self, sector=None, symmetry=None):
        """A vectorized predicate ``f(configs) -> bool mask`` selecting
        the sector (the reference compiles this with numba; here it is
        vectorized host numpy)."""
        symmetry = symmetry if symmetry is not None else self._symmetry
        sector = sector if sector is not None else self._sector
        n = self._nsites

        def predicate(configs):
            configs = np.asarray(configs, dtype=np.int64)
            pop = np.zeros_like(configs)
            for b in range(n):
                pop += (configs >> b) & 1
            if symmetry is None:
                return np.ones(configs.shape, dtype=bool)
            if symmetry == "Z2":
                want = {"even": 0, "odd": 1}.get(sector, sector)
                return (pop % 2) == (want % 2)
            if symmetry == "U1":
                return pop == sector
            if symmetry == "U1U1":
                ka, kb = sector
                na = n // 2
                pa = np.zeros_like(configs)
                for b in range(na):
                    pa += (configs >> b) & 1
                return (pa == ka) & ((pop - pa) == kb)
            raise ValueError(symmetry)

        return predicate

    def get_size(self, sector=None, symmetry=None):
        """Size of this (or another) sector of the same sites
        (reference ``get_size`` hilbertspace.py:486)."""
        if sector is None and symmetry is None:
            return self.size
        return HilbertSpace(
            self._sites,
            symmetry if symmetry is not None else self._symmetry,
            sector if sector is not None else self._sector,
        ).size

    # -- config format conversions ------------------------------------------

    def rank_to_flatconfig(self, rank):
        """Sector index -> (nsites,) uint8 occupation array."""
        c = int(self.unrank(np.asarray([rank]))[0])
        return self.config_to_bits([c])[0].astype(np.uint8)

    def flatconfig_to_rank(self, flatconfig):
        c = int(self.bits_to_config(
            np.asarray(flatconfig, dtype=np.int64)[None, :]
        )[0])
        return int(self.rank([c])[0])

    def config_to_flatconfig(self, config):
        """dict[site, int] -> (nsites,) uint8 array in register
        order."""
        fc = np.zeros(self._nsites, dtype=np.uint8)
        for site, v in config.items():
            fc[self.site_to_reg(site)] = v
        return fc

    def flatconfig_to_config(self, flatconfig):
        return {
            self.reg_to_site(r): int(v)
            for r, v in enumerate(flatconfig)
        }

    def rank_to_config(self, rank):
        return self.flatconfig_to_config(self.rank_to_flatconfig(rank))

    def config_to_rank(self, config):
        return self.flatconfig_to_rank(
            self.config_to_flatconfig(config)
        )

    def rand_rank(self, seed=None):
        rng = np.random.default_rng(seed)
        return int(rng.integers(self.size))

    def rand_flatconfig(self, seed=None):
        return self.rank_to_flatconfig(self.rand_rank(seed))

    @property
    def size(self):
        if self.symmetry is None:
            return 2**self.nsites
        if self.symmetry == "Z2":
            return 2 ** (self.nsites - 1)
        if self.symmetry == "U1":
            return int(math.comb(self.nsites, self.sector))
        if self.symmetry == "U1U1":
            ka, kb = self.sector
            na = self.nsites // 2
            return int(
                math.comb(na, ka) * math.comb(self.nsites - na, kb)
            )
        raise ValueError(self.symmetry)

    def get_configs(self):
        """All sector configurations as an int64 array (ordered by
        rank)."""
        if self._configs is not None:
            return self._configs
        n = self.nsites
        if n > 28 and self.symmetry in ("U1", "U1U1"):
            # sector-direct enumeration: 2**n is not enumerable, the
            # sector often is (reference configcore builds the same
            # flat config lists, configcore.py:112)
            import itertools

            if self.symmetry == "U1":
                combos = itertools.combinations(range(n), self.sector)
                out = np.fromiter(
                    (sum(1 << b for b in c) for c in combos),
                    dtype=np.int64,
                    count=int(math.comb(n, self.sector)),
                )
            else:
                ka, kb = self.sector
                na = n // 2
                nb = n - na
                la = [sum(1 << b for b in c) for c in
                      itertools.combinations(range(na), ka)]
                lb = [sum(1 << (na + b) for b in c) for c in
                      itertools.combinations(range(nb), kb)]
                out = np.asarray(
                    [a | b for b in lb for a in la], dtype=np.int64
                )
            out.sort()
            self._configs = out
            return out
        if self.symmetry is None:
            out = np.arange(2**n, dtype=np.int64)
        else:
            all_c = np.arange(2**n, dtype=np.int64)
            pop = np.zeros(2**n, dtype=np.int64)
            for b in range(n):
                pop += (all_c >> b) & 1
            if self.symmetry == "Z2":
                out = all_c[(pop % 2) == (self.sector % 2)]
            elif self.symmetry == "U1":
                out = all_c[pop == self.sector]
            elif self.symmetry == "U1U1":
                ka, kb = self.sector
                na = n // 2
                mask_a = (1 << na) - 1
                pa = np.zeros(2**n, dtype=np.int64)
                for b in range(na):
                    pa += (all_c >> b) & 1
                pb = pop - pa
                out = all_c[(pa == ka) & (pb == kb)]
            else:
                raise ValueError(self.symmetry)
        self._configs = out
        return out

    def rank(self, configs):
        """Map configuration integers to sector indices (vectorized).

        For 'U1' this is the combinatorial ranking the reference
        implements in numba (configcore.py:112); other sectors use a
        lookup table."""
        configs = np.asarray(configs, dtype=np.int64)
        if self.symmetry is None:
            return configs
        if self.nsites > 28:
            # a 2**nsites lookup table does not fit: binary-search the
            # (sorted) sector config list instead — O(log D) per query
            cs = self.get_configs()
            idx = np.searchsorted(cs, configs)
            idx = np.clip(idx, 0, cs.size - 1)
            return np.where(cs[idx] == configs, idx, -1)
        if self._rank_lookup is None:
            cs = self.get_configs()
            lut = np.full(2**self.nsites, -1, dtype=np.int64)
            lut[cs] = np.arange(cs.size)
            self._rank_lookup = lut
        return self._rank_lookup[configs]

    def unrank(self, indices):
        return self.get_configs()[np.asarray(indices)]

    def config_to_bits(self, configs):
        """(batch,) ints -> (batch, nsites) bit array (site 0 = LSB)."""
        configs = np.asarray(configs, dtype=np.int64)
        return (
            (configs[..., None] >> np.arange(self.nsites)) & 1
        ).astype(np.int8)

    def bits_to_config(self, bits):
        bits = np.asarray(bits, dtype=np.int64)
        return (bits << np.arange(self.nsites)).sum(axis=-1)

    def rand_config(self, seed=None):
        """A random sector configuration as ``dict[site, int]``
        (reference ``rand_config`` hilbertspace.py:696)."""
        return self.flatconfig_to_config(self.rand_flatconfig(seed))

    def __repr__(self):
        return (
            f"HilbertSpace(nsites={self.nsites}, "
            f"symmetry={self.symmetry}, sector={self.sector}, "
            f"size={self.size})"
        )
