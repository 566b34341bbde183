"""2D tensor networks: PEPS, PEPO, boundary contraction, environments.

Port of quimb_tpu's ``tensor/tn2d/core.py`` (reference
``quimb/tensor/tn2d/core.py``: ``TensorNetwork2D`` :355, boundary
contraction core :1355 / ``contract_boundary`` :2502, environments
``compute_environments`` :2716, ``compute_local_expectation`` :4223,
``PEPS`` :4613, ``PEPO`` :5068).

Each boundary step contracts a row into the boundary tensor by tensor,
then canonizes and compresses along it (QR and truncated SVD), on the
device of the network's tensors. ``compute_local_expectation`` contracts
there too; a caller who wants host contractions enters
``contract_backend("numpy")`` with host arrays. The ``"full-bond"``
boundary mode compresses each new bond against its whole environment,
from lazily computed opposite-direction environments; the coarse-graining
schemes are ``contract_hotrg`` (pairwise row and column merges with bond
truncation) and ``contract_ctmrg`` (boundaries absorbed from all four
sides in turn).
"""

import functools
import itertools

import numpy as np
import torch

from ...utils import check_opt, oset, pairwise
from ..core import (
    Tensor,
    TensorNetwork,
    bonds,
    rand_uuid,
    tags_to_oset,
)


def gen_2d_bonds(Lx, Ly, steppers=None, coo_filter=None, cyclic=False):
    """Generate 2D lattice bond pairs (reference ``gen_2d_bonds``)."""
    if steppers is None:
        steppers = [lambda i, j: (i, j + 1), lambda i, j: (i + 1, j)]
    if callable(steppers):
        steppers = (steppers,)
    try:
        cyclic_x, cyclic_y = cyclic
    except TypeError:
        cyclic_x = cyclic_y = cyclic
    for i, j in itertools.product(range(Lx), range(Ly)):
        if coo_filter is None or coo_filter(i, j):
            for stepper in steppers:
                i2, j2 = stepper(i, j)
                if (0 <= i2 < Lx or cyclic_x) and \
                        (0 <= j2 < Ly or cyclic_y):
                    yield (i, j), (i2 % Lx, j2 % Ly)


class TensorNetwork2D(TensorNetwork):
    """A 2D-structured TN: tensors tagged ``I{i},{j}``, row tags
    ``X{i}``, column tags ``Y{j}``."""

    _EXTRA_PROPS = ("_site_tag_id", "_x_tag_id", "_y_tag_id", "_Lx",
                    "_Ly")

    @property
    def Lx(self):
        return self._Lx

    @property
    def Ly(self):
        return self._Ly

    @property
    def nsites(self):
        return self._Lx * self._Ly

    @property
    def site_tag_id(self):
        return self._site_tag_id

    def site_tag(self, i, j=None):
        if j is None:
            i, j = i
        return self._site_tag_id.format(i % self._Lx, j % self._Ly)

    @property
    def x_tag_id(self):
        return self._x_tag_id

    def x_tag(self, i):
        return self._x_tag_id.format(i % self._Lx)

    @property
    def y_tag_id(self):
        return self._y_tag_id

    def y_tag(self, j):
        return self._y_tag_id.format(j % self._Ly)

    row_tag = x_tag
    col_tag = y_tag

    @property
    def site_tags(self):
        return tuple(
            self.site_tag(i, j) for i, j in self.gen_site_coos()
        )

    def gen_site_coos(self):
        return itertools.product(range(self._Lx), range(self._Ly))

    @property
    def sites(self):
        """All (i, j) site coordinates (reference ``sites``
        tensor_2d.py)."""
        return tuple(self.gen_site_coos())

    def gen_bond_coos(self):
        return gen_2d_bonds(self._Lx, self._Ly)

    def maybe_convert_coo(self, x):
        if isinstance(x, tuple) and len(x) == 2 and all(
            isinstance(v, (int, np.integer)) for v in x
        ):
            return self.site_tag(*x)
        return x

    def _repr_info(self):
        return f"Lx={self._Lx}, Ly={self._Ly}"

    # -- boundary contraction ------------------------------------------------

    def _contract_boundary_single(
        self, xrange, yrange, from_which, max_bond=None, cutoff=1e-10,
        canonize=True, compress_sweep=None, layer_tags=None,
        equalize_norms=False,
    ):
        """Absorb one row (or column) into the boundary then compress
        along it (reference ``_contract_boundary_core``
        tn2d/core.py:1355, single-layer case)."""
        if from_which in ("xmin", "xmax"):
            # combining rows x0, x1 into x1 position... absorb xi into
            # the boundary already at position
            if from_which == "xmin":
                x0, x1 = xrange[0], xrange[0] + 1
            else:
                x0, x1 = xrange[1], xrange[1] - 1
            js = range(yrange[0], yrange[1] + 1)
            # contract column by column
            for j in js:
                tag0, tag1 = self.site_tag(x0, j), self.site_tag(x1, j)
                if tag0 in self.tag_map and tag1 in self.tag_map:
                    self.contract_tags_(
                        (tag0, tag1), which="any",
                    )
                elif tag0 in self.tag_map:
                    # retag lone boundary tensor into the new row
                    for tid in self.tag_map[tag0]:
                        self.tensor_map[tid].add_tag(tag1)
            # drop old row tags, ensure new tags
            for j in js:
                tag0, tag1 = self.site_tag(x0, j), self.site_tag(x1, j)
                if tag0 in self.tag_map:
                    for tid in tuple(self.tag_map[tag0]):
                        t = self.tensor_map[tid]
                        t.drop_tags((tag0, self.x_tag(x0)))
                        t.add_tag((tag1, self.x_tag(x1),
                                   self.y_tag(j)))
            # compress along the new boundary row
            if max_bond is not None or cutoff:
                jlist = list(js)
                if canonize:
                    for ja, jb in pairwise(reversed(jlist)):
                        try:
                            self.canonize_between(
                                self.site_tag(x1, jb),
                                self.site_tag(x1, ja),
                                absorb="right",
                            )
                        except (KeyError, ValueError):
                            pass
                        # the absorbed gauge piles the whole row norm
                        # (~q^Ly) into the terminal tensor: strip it
                        # into TN.exponent each step or the sweep
                        # underflows f32 at Ly >~ 14
                        self._strip_tag_exponent(self.site_tag(x1, jb))
                for ja, jb in pairwise(jlist):
                    try:
                        self.compress_between(
                            self.site_tag(x1, ja),
                            self.site_tag(x1, jb),
                            max_bond=max_bond, cutoff=cutoff,
                            absorb="right",
                        )
                    except (KeyError, ValueError):
                        pass
                    self._strip_tag_exponent(self.site_tag(x1, jb))
        else:
            if from_which == "ymin":
                y0, y1 = yrange[0], yrange[0] + 1
            else:
                y0, y1 = yrange[1], yrange[1] - 1
            is_ = range(xrange[0], xrange[1] + 1)
            for i in is_:
                tag0, tag1 = self.site_tag(i, y0), self.site_tag(i, y1)
                if tag0 in self.tag_map and tag1 in self.tag_map:
                    self.contract_tags_((tag0, tag1), which="any")
                elif tag0 in self.tag_map:
                    for tid in self.tag_map[tag0]:
                        self.tensor_map[tid].add_tag(tag1)
            for i in is_:
                tag0, tag1 = self.site_tag(i, y0), self.site_tag(i, y1)
                if tag0 in self.tag_map:
                    for tid in tuple(self.tag_map[tag0]):
                        t = self.tensor_map[tid]
                        t.drop_tags((tag0, self.y_tag(y0)))
                        t.add_tag((tag1, self.y_tag(y1),
                                   self.x_tag(i)))
            if max_bond is not None or cutoff:
                ilist = list(is_)
                if canonize:
                    for ia, ib in pairwise(reversed(ilist)):
                        try:
                            self.canonize_between(
                                self.site_tag(ib, y1),
                                self.site_tag(ia, y1),
                                absorb="right",
                            )
                        except (KeyError, ValueError):
                            pass
                        self._strip_tag_exponent(self.site_tag(ib, y1))
                for ia, ib in pairwise(ilist):
                    try:
                        self.compress_between(
                            self.site_tag(ia, y1),
                            self.site_tag(ib, y1),
                            max_bond=max_bond, cutoff=cutoff,
                            absorb="right",
                        )
                    except (KeyError, ValueError):
                        pass
                    self._strip_tag_exponent(self.site_tag(ib, y1))
        if equalize_norms:
            self.equalize_norms_()
        return self

    def _strip_tag_exponent(self, tag):
        """Rescale the tensor(s) under ``tag`` to unit norm, folding
        the factor into ``self.exponent`` (f32 range safety for the
        boundary canonize/compress sweeps)."""
        for tid in tuple(self.tag_map.get(tag, ())):
            self.strip_exponent(tid)

    def _boundary_step(self, xrange, yrange, from_which, max_bond=None,
                       cutoff=1e-10, mode="mps", **opts):
        """One inward absorb-and-compress step with any ``mode`` (the
        shared dispatch for sweeps and environment builders)."""
        if mode == "mps":
            return self._contract_boundary_single(
                xrange, yrange, from_which, max_bond=max_bond,
                cutoff=cutoff, **opts,
            )
        if mode == "projector2d":
            return self._contract_boundary_single_projector(
                xrange, yrange, from_which, max_bond=max_bond,
                cutoff=cutoff, **opts,
            )
        return self._contract_boundary_single_via_1d(
            xrange, yrange, from_which, max_bond=max_bond,
            cutoff=cutoff, method=mode, **opts,
        )

    def _contract_boundary_single_via_1d(
        self, xrange, yrange, from_which, max_bond=None, cutoff=1e-10,
        method="dm", canonize=True, **compress_opts,
    ):
        """Absorb one row into the boundary by 1D-compressing the
        two-row strip with ``method`` — never forming fat site columns
        for the structure-preserving methods (reference
        ``_contract_boundary_core_via_1d`` tn2d/core.py:1273)."""
        from ..tn1d.compress import tensor_network_1d_compress

        r = Rotator2D(self, xrange, yrange, from_which)
        i = r.sweep[0]
        inext = i + r.istep

        st_tmps = [f"__ST{j}__" for j in r.sweep_other]
        tagged = []
        for j, st in zip(r.sweep_other, st_tmps):
            for tag in (r.site_tag(i, j), r.site_tag(inext, j)):
                for tid in tuple(self.tag_map.get(tag, ())):
                    t = self.tensor_map[tid]
                    if st not in t.tags:
                        t.add_tag(st)
                        tagged.append((t, st))

        # split the strip off, 1D-compress it in place, recombine
        strip = self.partition(st_tmps, which="any", inplace=True)[1]
        tensor_network_1d_compress(
            strip, max_bond=max_bond, cutoff=cutoff, method=method,
            site_tags=st_tmps, inplace=True, **compress_opts,
        )
        self.add_tensor_network(strip, virtual=True)

        # the compressed strip becomes row ``inext``
        for j, st in zip(r.sweep_other, st_tmps):
            for tid in tuple(self.tag_map.get(st, ())):
                t = self.tensor_map[tid]
                t.drop_tags((st, r.site_tag(i, j), r.x_tag(i)))
                t.add_tag((r.site_tag(inext, j), r.x_tag(inext),
                           r.y_tag(j)))
        for t, st in tagged:
            if st in t.tags:
                t.drop_tags(st)
        return self

    def _contract_boundary_single_projector(
        self, xrange, yrange, from_which, max_bond=None, cutoff=1e-10,
        lazy=False, canonize=False, optimize="auto",
        **compress_opts,
    ):
        """Absorb one row into the boundary by inserting oblique
        projectors computed from the frozen two-row region, then
        contracting each site pair — multilayer networks supported
        naturally (reference ``_contract_boundary_projector``
        tn2d/core.py:1659)."""
        r = Rotator2D(self, xrange, yrange, from_which)
        i = r.sweep[0]
        inext = i + r.istep

        # all projectors are computed from the same frozen copy while
        # being spliced into self
        tn_calc = self.copy()
        for j in r.sweep_other:
            jnext = r.get_jnext(j)
            if jnext is None:
                continue
            ltags = (r.site_tag(i, j), r.site_tag(inext, j))
            rtags = (r.site_tag(i, jnext), r.site_tag(inext, jnext))
            tn_calc.insert_compressor_between_regions(
                ltags, rtags, new_ltags=ltags, new_rtags=rtags,
                insert_into=self, max_bond=max_bond, cutoff=cutoff,
                **compress_opts,
            )

        if not lazy:
            for j in r.sweep_other:
                self.contract_tags_(
                    (r.site_tag(i, j), r.site_tag(inext, j)),
                    which="any",
                )
        # the merged tensors become row ``inext``
        for j in r.sweep_other:
            tag0 = r.site_tag(i, j)
            for tid in tuple(self.tag_map.get(tag0, ())):
                t = self.tensor_map[tid]
                t.drop_tags((tag0, r.x_tag(i)))
                t.add_tag((r.site_tag(inext, j), r.x_tag(inext),
                           r.y_tag(j)))
        return self

    def _contract_boundary_full_bond(
        self, xrange, yrange, from_which, max_bond, cutoff=0.0,
        method="eigh", renorm=False, optimize="auto",
        opposite_envs=None, canonize_opts=None,
        contract_boundary_opts=None,
    ):
        """Contract the boundary, compressing each new bond against the
        whole environment of the rest of the network: the row's ladder
        with the opposite-direction boundary environment, computed lazily
        (once, into ``opposite_envs``) and reused (reference
        ``_contract_boundary_full_bond`` tn2d/core.py:1486)."""
        from ...ops import decomp

        contract_boundary_opts = dict(contract_boundary_opts or {})
        contract_boundary_opts.setdefault("max_bond", max_bond)
        contract_boundary_opts.setdefault("cutoff", cutoff)

        r = Rotator2D(self, xrange, yrange, from_which)
        jmin, jmax, istep = r.jmin, r.jmax, r.istep
        if jmin == jmax:
            # absorbing the last row would contract the whole network to a
            # scalar and leave it empty (quimb_tpu's does)
            raise ValueError("full-bond needs two or more columns across "
                             "the sweep: one column has no boundary bond")

        # the opposite environments, and how to compute them
        if r.plane == "x":
            env_location = "xmax" if from_which == "xmin" else "xmin"
            env_fn = functools.partial(self.compute_x_environments,
                                       **contract_boundary_opts)
        else:
            env_location = "ymax" if from_which == "ymin" else "ymin"
            env_fn = functools.partial(self.compute_y_environments,
                                       **contract_boundary_opts)
        if opposite_envs is None:
            opposite_envs = {}

        for i in r.sweep[:-1]:
            inext = i + istep
            # absorb row i into row inext, column by column, exactly
            for j in r.sweep_other:
                self.contract_tags_(
                    (r.site_tag(i, j), r.site_tag(inext, j)), which="any")
            for j in r.sweep_other:
                tag0 = r.site_tag(i, j)
                for tid in tuple(self.tag_map.get(tag0, ())):
                    t = self.tensor_map[tid]
                    t.drop_tags((tag0, r.x_tag(i)))
                    t.add_tag((r.site_tag(inext, j), r.x_tag(inext),
                               r.y_tag(j)))

            # condition the new boundary row: canonical around its middle
            # (a row of one tensor has no bond to canonize)
            row = self.select(r.x_tag(inext), which="any")
            if row.num_tensors > 1:
                row.canonize_around_(r.y_tag((jmax + jmin) // 2))

            if (env_location, inext) not in opposite_envs:
                opposite_envs.update(env_fn())
            env = opposite_envs[env_location, inext]

            ladder = TensorNetwork(tuple(row) + tuple(env), virtual=False,
                                   check_collisions=False)
            # the ladder's partial environments from each end
            lenvs = {jmin + 1: ladder.select(r.y_tag(jmin), "any")}
            for j in range(jmin + 2, jmax):
                lenvs[j] = (ladder.select(r.y_tag(j - 1), "any")
                            & lenvs[j - 1]).contract()
            renvs = {jmax - 1: ladder.select(r.y_tag(jmax), "any")}
            for j in range(jmax - 2, jmin, -1):
                renvs[j] = (ladder.select(r.y_tag(j + 1), "any")
                            & renvs[j + 1]).contract()

            for j in range(jmin, jmax):
                ta = self[r.site_tag(inext, j)]
                tb = self[r.site_tag(inext, j + 1)]
                bdim = 1
                for ix in ta.bonds(tb):
                    bdim *= ta.ind_size(ix)
                if bdim <= max_bond:
                    continue
                # the bond's environment: the bond cut open in a copy of
                # the ladder restricted to this column pair
                tn_be = TensorNetwork((), virtual=True)
                if j in lenvs:
                    tn_be &= lenvs[j]
                tn_be &= ladder.select_any([r.y_tag(j), r.y_tag(j + 1)])
                if j + 1 in renvs:
                    tn_be &= renvs[j + 1]
                tn_be = tn_be.copy()
                lcut, rcut = rand_uuid(), rand_uuid()
                tn_be.cut_between(r.site_tag(inext, j),
                                  r.site_tag(inext, j + 1),
                                  left_ind=lcut, right_ind=rcut)
                E = tn_be.to_dense([rcut], [lcut])
                Cl, Cr = decomp.similarity_compress(
                    E, max_bond, method=method, renorm=renorm)
                self.insert_gauge(Cr, [r.site_tag(inext, j)],
                                  [r.site_tag(inext, j + 1)], Cl)
        return self

    def contract_boundary_from(
        self, from_which, max_bond=None, cutoff=1e-10, sequence=None,
        xrange=None, yrange=None, max_separation=1, canonize=True,
        mode="mps", inplace=False, **opts,
    ):
        """Contract a rectangular patch inwards from one boundary.

        ``mode`` selects the compression scheme (reference
        ``contract_boundary_from`` tn2d/core.py:1763):

        - ``"mps"``: eagerly contract each site column then
          canonize + compress pairwise along the boundary (the
          default, reference ``_contract_boundary_core``).
        - ``"projector2d"``: insert oblique projectors computed from
          the frozen two-row region, never forming fat site tensors
          (reference ``_contract_boundary_projector`` :1659).
        - ``"full-bond"``: compress each boundary bond using the full
          remaining-network environment from an opposite-direction
          boundary contraction (reference
          ``_contract_boundary_full_bond`` :1486).
        - any 1D compression method name (``"dm"``, ``"zipup"``,
          ``"fit"``, ``"direct"``, ...): treat the two-row strip as a
          1D-like network and delegate to
          :func:`tensor_network_1d_compress` (reference
          ``_contract_boundary_core_via_1d`` :1273).
        """
        tn = self if inplace else self.copy()
        if xrange is None:
            xrange = (0, tn._Lx - 1)
        if yrange is None:
            yrange = (0, tn._Ly - 1)
        xrange, yrange = list(xrange), list(yrange)

        if mode == "full-bond":
            opts.setdefault("canonize_opts", None)
            opposite_envs = opts.pop("opposite_envs", None)
            tn._contract_boundary_full_bond(
                tuple(xrange), tuple(yrange), from_which,
                max_bond=max_bond, cutoff=cutoff,
                opposite_envs=opposite_envs, **opts,
            )
            return tn

        while (from_which in ("xmin", "xmax") and
               xrange[1] - xrange[0] >= 1) or \
              (from_which in ("ymin", "ymax") and
               yrange[1] - yrange[0] >= 1):
            if mode == "mps":
                opts["canonize"] = canonize
            tn._boundary_step(
                tuple(xrange), tuple(yrange), from_which,
                max_bond=max_bond, cutoff=cutoff, mode=mode, **opts,
            )
            if from_which == "xmin":
                xrange[0] += 1
            elif from_which == "xmax":
                xrange[1] -= 1
            elif from_which == "ymin":
                yrange[0] += 1
            else:
                yrange[1] -= 1
        return tn

    contract_boundary_from_xmin = functools.partialmethod(
        contract_boundary_from, "xmin")
    contract_boundary_from_xmax = functools.partialmethod(
        contract_boundary_from, "xmax")
    contract_boundary_from_ymin = functools.partialmethod(
        contract_boundary_from, "ymin")
    contract_boundary_from_ymax = functools.partialmethod(
        contract_boundary_from, "ymax")

    def contract_boundary(
        self, max_bond=None, cutoff=1e-10, sequence=("xmin", "xmax"),
        max_separation=1, mode="mps", inplace=False, **opts,
    ):
        """Contract the whole network via alternating boundary sweeps
        (reference ``contract_boundary`` tn2d/core.py:2502). ``mode``
        selects the boundary compression scheme — see
        :meth:`contract_boundary_from`."""
        tn = self if inplace else self.copy()
        xrange = [0, tn._Lx - 1]
        yrange = [0, tn._Ly - 1]
        seq = itertools.cycle(sequence)
        has_x = any(d in ("xmin", "xmax") for d in sequence)
        has_y = any(d in ("ymin", "ymax") for d in sequence)
        # full-bond's opposite-direction environments assume the far
        # side is untouched: sweep the whole grid from one direction
        if mode == "full-bond":
            d = sequence[0]
            across = yrange if d in ("xmin", "xmax") else xrange
            if across[0] == across[1]:
                # one column: no boundary bond to compress, the exact value
                return tn.contract(...)
            tn.contract_boundary_from(
                d, max_bond=max_bond, cutoff=cutoff,
                xrange=tuple(xrange), yrange=tuple(yrange),
                mode=mode, inplace=True, **opts,
            )
            return tn.contract(...)
        while (has_x and xrange[1] - xrange[0] > max_separation) or \
              (has_y and yrange[1] - yrange[0] > max_separation):
            d = next(seq)
            if d in ("xmin", "xmax") and \
                    xrange[1] - xrange[0] <= max_separation:
                continue
            if d in ("ymin", "ymax") and \
                    yrange[1] - yrange[0] <= max_separation:
                continue
            tn._boundary_step(
                tuple(xrange), tuple(yrange), d, max_bond=max_bond,
                cutoff=cutoff, mode=mode, **opts,
            )
            if d == "xmin":
                xrange[0] += 1
            elif d == "xmax":
                xrange[1] -= 1
            elif d == "ymin":
                yrange[0] += 1
            else:
                yrange[1] -= 1
        return tn.contract(...)

    # -- environments -----------------------------------------------------------

    def compute_x_environments(self, max_bond=None, cutoff=1e-10,
                               **opts):
        """Boundary environments for every row: ``envs['xmin', i]`` =
        boundary of rows < i, ``envs['xmax', i]`` = rows > i
        (reference ``compute_environments`` tn2d/core.py:2716)."""
        envs = {}
        envs["xmin", 0] = TensorNetwork(())
        # incremental bottom-up:
        boundary = None
        for i in range(self._Lx - 1):
            if boundary is None:
                boundary = self.select(self.x_tag(0), which="any").copy()
                boundary.view_like_(self)
            else:
                # add row i and contract into it
                row = self.select(self.x_tag(i), which="any").copy()
                boundary.add_tensor_network(row, virtual=True,
                                            check_collisions=False)
                boundary.view_like_(self)
                boundary._boundary_step(
                    (i - 1, i), (0, self._Ly - 1), "xmin",
                    max_bond=max_bond, cutoff=cutoff, **opts,
                )
                # keep the boundary mantissas O(1): the absorbed-row
                # product underflows f32 within ~dozens of sites; the
                # scale rides TN.exponent (propagated on combination,
                # applied at contraction)
                boundary.equalize_norms_(1.0)
            env = boundary.copy()
            envs["xmin", i + 1] = env
            if i == 0:
                # compress the first row too
                pass
        # top-down
        envs["xmax", self._Lx - 1] = TensorNetwork(())
        boundary = None
        for i in range(self._Lx - 1, 0, -1):
            if boundary is None:
                boundary = self.select(
                    self.x_tag(self._Lx - 1), which="any"
                ).copy()
                boundary.view_like_(self)
            else:
                row = self.select(self.x_tag(i), which="any").copy()
                boundary.add_tensor_network(row, virtual=True,
                                            check_collisions=False)
                boundary.view_like_(self)
                boundary._boundary_step(
                    (i, i + 1), (0, self._Ly - 1), "xmax",
                    max_bond=max_bond, cutoff=cutoff, **opts,
                )
                boundary.equalize_norms_(1.0)
            envs["xmax", i - 1] = boundary.copy()
        return envs

    def compute_y_environments(self, max_bond=None, cutoff=1e-10,
                               **opts):
        envs = {}
        boundary = None
        for j in range(self._Ly - 1):
            if boundary is None:
                boundary = self.select(self.y_tag(0), which="any").copy()
                boundary.view_like_(self)
            else:
                col = self.select(self.y_tag(j), which="any").copy()
                boundary.add_tensor_network(col, virtual=True,
                                            check_collisions=False)
                boundary.view_like_(self)
                boundary._boundary_step(
                    (0, self._Lx - 1), (j - 1, j), "ymin",
                    max_bond=max_bond, cutoff=cutoff, **opts,
                )
                boundary.equalize_norms_(1.0)
            envs["ymin", j + 1] = boundary.copy()
        envs["ymin", 0] = TensorNetwork(())
        boundary = None
        for j in range(self._Ly - 1, 0, -1):
            if boundary is None:
                boundary = self.select(
                    self.y_tag(self._Ly - 1), which="any"
                ).copy()
                boundary.view_like_(self)
            else:
                col = self.select(self.y_tag(j), which="any").copy()
                boundary.add_tensor_network(col, virtual=True,
                                            check_collisions=False)
                boundary.view_like_(self)
                boundary._boundary_step(
                    (0, self._Lx - 1), (j, j + 1), "ymax",
                    max_bond=max_bond, cutoff=cutoff, **opts,
                )
                boundary.equalize_norms_(1.0)
            envs["ymax", j - 1] = boundary.copy()
        envs["ymax", self._Ly - 1] = TensorNetwork(())
        return envs


class TensorNetwork2DVector(TensorNetwork2D):
    """2D TN with one physical index per site."""

    _EXTRA_PROPS = (
        "_site_tag_id", "_x_tag_id", "_y_tag_id", "_Lx", "_Ly",
        "_site_ind_id",
    )

    @property
    def site_ind_id(self):
        return self._site_ind_id

    def site_ind(self, i, j=None):
        if j is None:
            i, j = i
        return self._site_ind_id.format(i % self._Lx, j % self._Ly)

    @property
    def site_inds(self):
        return tuple(
            self.site_ind(i, j) for i, j in self.gen_site_coos()
        )

    def phys_dim(self, i=0, j=0):
        return self.ind_size(self.site_ind(i, j))

    def to_dense(self, *inds_seq, **contract_opts):
        if not inds_seq:
            inds_seq = (self.site_inds,)
        t = self.contract(
            ..., output_inds=tuple(
                ix for g in inds_seq for ix in g
            ), preserve_tensor=True, **contract_opts,
        )
        return t.data.reshape(-1, 1)

    def make_norm(self, layer_tags=("KET", "BRA")):
        """<psi|psi> as a 2D TN (bra and ket layered)."""
        ket = self.copy()
        ket.add_tag(layer_tags[0])
        bra = ket.H
        bra.retag_({layer_tags[0]: layer_tags[1]})
        bra.mangle_inner_("*")
        norm = ket & bra
        norm.view_like_(self)
        return norm

    def norm2(self, max_bond=None, cutoff=1e-10, **opts):
        """<psi|psi> via boundary contraction."""
        norm = self.make_norm()
        if max_bond is None:
            max_bond = max(8, 2 * (self.max_bond() or 2) ** 2)
        return norm.contract_boundary(
            max_bond=max_bond, cutoff=cutoff, **opts
        )

    def gate(self, G, where, contract=False, tags=None, inplace=False,
             **opts):
        """Apply a gate to site(s) ``where`` (reference 2D vector
        gate)."""
        from ..gating import tensor_network_gate_inds

        if isinstance(where[0], (int, np.integer)):
            where = (where,)
        inds = tuple(self.site_ind(*coo) for coo in where)
        psi = self if inplace else self.copy()
        if len(inds) == 1:
            contract = True
        tensor_network_gate_inds(
            psi, G, inds, contract=contract, tags=tags, inplace=True,
            **opts,
        )
        return psi

    gate_ = functools.partialmethod(gate, inplace=True)

    def compute_local_expectation(
        self, terms, max_bond=None, cutoff=1e-10, normalized=True,
        autogroup=True, return_all=False, **boundary_opts,
    ):
        """Expectation of a dict of local terms ``{(coo1, coo2): G}``
        via boundary environments (reference
        ``compute_local_expectation`` tn2d/core.py:4223). Every
        contraction runs where the network's tensors are: on the card
        for CUDA tensors, on the host for numpy arrays inside
        ``contract_backend("numpy")``."""
        return self._local_expectation_plaquettes(
            self.make_norm(), terms, max_bond, cutoff, normalized,
            return_all, boundary_opts,
        )

    def _local_expectation_plaquettes(
        self, norm, terms, max_bond, cutoff, normalized, return_all,
        boundary_opts,
    ):
        if normalized:
            # every (value, norm) pair below contracts the SAME
            # plaquette tensors, so their ratio is invariant to
            # per-tensor rescaling — equalize norms up front so a
            # long-evolved state (e.g. unit-conditioned SimpleUpdate
            # tensors whose global norm is ~1e-24) cannot underflow float32
            norm.equalize_norms_(1.0)
        if max_bond is None:
            max_bond = max(8, 2 * (self.max_bond() or 2) ** 2)

        # plaquette environments per bounding-box shape: the row strip
        # AND within-strip column sweeps are each computed once and
        # shared by every term of that shape — O(local) work per term,
        # vs re-contracting a whole O(L) strip per term (reference
        # compute_local_expectation tn2d/core.py:4223 autogroups the
        # same way)
        env_maps = {}
        x_envs = None
        results = {}
        for where, G in terms.items():
            if isinstance(where[0], (int, np.integer)):
                where = (where,)
            xs = sorted(set(coo[0] for coo in where))
            ys = sorted(set(coo[1] for coo in where))
            x0, y0 = xs[0], ys[0]
            bsz = (xs[-1] - x0 + 1, ys[-1] - y0 + 1)
            envs = env_maps.get(bsz)
            if envs is None:
                if x_envs is None:
                    x_envs = norm.compute_x_environments(
                        max_bond=max_bond, cutoff=cutoff,
                        **boundary_opts,
                    )
                envs = env_maps[bsz] = \
                    norm.compute_plaquette_environments(
                        x_bsz=bsz[0], y_bsz=bsz[1], max_bond=max_bond,
                        cutoff=cutoff, x_envs=x_envs, **boundary_opts,
                    )
            plq = envs[((x0, y0), bsz)].copy()
            for dx in range(bsz[0]):
                for dy in range(bsz[1]):
                    sel = norm.select(
                        norm.site_tag(x0 + dx, y0 + dy), which="any"
                    )
                    for t in sel.tensor_map.values():
                        plq.add_tensor(t.copy(), virtual=True)

            # ONE scale-free contraction per term: cut the bra/ket
            # phys bonds open and contract to the local reduced
            # density environment with per-step renormalization —
            # <G> and <1> then come from the SAME rho, so their ratio
            # is exact while neither can under/overflow float32
            rho, _, _ = self._plaquette_rho(plq, where)
            ev, nval = _rho_expectation(rho, G)
            results[tuple(where)] = (ev, nval)

        if return_all:
            return {
                k: (complex(v), complex(n)) for k, (v, n) in
                results.items()
            }
        total = 0.0
        for (v, n) in results.values():
            total += complex(v) / (complex(n) if normalized else 1.0)
        return total.real if abs(total.imag) < 1e-10 else total

    def _plaquette_rho(self, strip, where):
        """Cut the bra/ket phys bonds of ``where`` open and contract
        the plaquette to the local reduced density environment, with
        per-step renormalization (scale-free — safe at any depth in
        f32). Returns ``(rho (d, d) array, ket_inds, bra_inds)``."""
        ixs = [self.site_ind(*coo) for coo in where]
        cut = []
        for ix in ixs:
            tids = strip.ind_map.get(ix)
            ket_tids = [
                t for t in tids if "KET" in strip.tensor_map[t].tags
            ]
            new_ix = rand_uuid()
            for t in ket_tids:
                strip.tensor_map[t].reindex_({ix: new_ix})
            cut.append(new_ix)
        out = (*cut, *ixs)
        # scale-free: drop the accumulated exponent (10**exp overflows
        # float32 long before the normalized expectation does) and
        # renormalize every intermediate
        strip.exponent = 0.0
        t = strip.contract(
            ..., output_inds=out, preserve_tensor=True, renorm=True
        )
        d = int(np.prod([strip.ind_size(ix) for ix in ixs]))
        return t.data.reshape(d, d), cut, ixs

    def _strip_expectation(self, strip, where, G):
        """Insert operator G on the bra-ket bond of sites ``where``
        within a norm-strip TN and contract."""
        # in `make_norm` ket site inds got contracted directly with bra
        # ones. To insert G we cut those indices at the given sites.
        # Here instead we rebuild: the strip contains both layers; the
        # phys bond between them at site (i,j) is the (hyper) index
        # site_ind(i, j).
        ixs = [self.site_ind(*coo) for coo in where]
        cut_map = {}
        for ix in ixs:
            tids = strip.ind_map.get(ix)
            # split the hyperindex between KET and BRA layer
            ket_tids = [
                t for t in tids if "KET" in strip.tensor_map[t].tags
            ]
            new_ix = rand_uuid()
            for t in ket_tids:
                strip.tensor_map[t].reindex_({ix: new_ix})
            cut_map[ix] = new_ix
        gshape = tuple(strip.ind_size(ix) for ix in ixs) * 2
        ref = next(iter(strip.tensor_map.values())).data
        GT = Tensor(_operator_like(G, ref).reshape(gshape),
                    inds=(*ixs, *[cut_map[ix] for ix in ixs]))
        strip.add_tensor(GT, virtual=True)
        return strip.contract(...)


def _operator_like(G, ref):
    """The operator ``G`` (a tensor or an array-like) in the residence
    and dtype of the array ``ref``; a complex operator on a real network
    keeps its real part (expm of a real Hamiltonian)."""
    if isinstance(ref, np.ndarray):
        from ...ops.backend import to_host

        gh = np.asarray(to_host(G))
        if np.iscomplexobj(gh) and not np.iscomplexobj(ref):
            gh = gh.real
        return gh.astype(ref.dtype)
    if not isinstance(G, torch.Tensor):
        G = torch.as_tensor(np.asarray(G))
    if G.is_complex() and not ref.is_complex():
        G = G.real
    return G.to(device=ref.device, dtype=ref.dtype)


def _rho_expectation(rho, G):
    """``(tr(G rho), tr(rho))`` with G reshaped/cast to match ``rho``'s
    dtype and residency; rho rows are the (cut) ket legs, columns the
    bra legs, so ``<G> = sum_{b,k} G[b,k] rho[k,b]``."""
    d = rho.shape[0]
    gh = _operator_like(G, rho).reshape(d, d)
    return (gh * rho.T).sum(), rho.trace()


# ---------------------------------------------------------------------------
# PEPS / PEPO
# ---------------------------------------------------------------------------


class PEPS(TensorNetwork2DVector):
    """Projected entangled pair state (reference ``PEPS``
    tn2d/core.py:4613). Array order 'urdlp' with missing edge bonds
    dropped."""

    _EXTRA_PROPS = (
        "_site_tag_id", "_x_tag_id", "_y_tag_id", "_Lx", "_Ly",
        "_site_ind_id",
    )

    def __init__(self, arrays, *, shape="urdlp", tags=None,
                 site_ind_id="k{},{}", site_tag_id="I{},{}",
                 x_tag_id="X{}", y_tag_id="Y{}", **tn_opts):
        if isinstance(arrays, PEPS):
            super().__init__(arrays)
            return
        arrays = tuple(tuple(row) for row in arrays)
        self._Lx = len(arrays)
        self._Ly = len(arrays[0])
        self._site_ind_id = site_ind_id
        self._site_tag_id = site_tag_id
        self._x_tag_id = x_tag_id
        self._y_tag_id = y_tag_id
        tags = tags_to_oset(tags)

        # vertical bonds [i][j]: between (i, j) and (i+1, j)
        vbonds = [
            [rand_uuid() for _ in range(self._Ly)]
            for _ in range(self._Lx - 1)
        ]
        hbonds = [
            [rand_uuid() for _ in range(self._Ly - 1)]
            for _ in range(self._Lx)
        ]
        tensors = []
        for i, j in itertools.product(range(self._Lx), range(self._Ly)):
            arr = arrays[i][j]
            inds = []
            for c in shape:
                if c == "u" and i < self._Lx - 1:
                    inds.append(vbonds[i][j])
                elif c == "d" and i > 0:
                    inds.append(vbonds[i - 1][j])
                elif c == "r" and j < self._Ly - 1:
                    inds.append(hbonds[i][j])
                elif c == "l" and j > 0:
                    inds.append(hbonds[i][j - 1])
                elif c == "p":
                    inds.append(site_ind_id.format(i, j))
            tensors.append(Tensor(
                arr, inds=inds,
                tags=tags | oset((
                    site_tag_id.format(i, j), x_tag_id.format(i),
                    y_tag_id.format(j),
                )),
            ))
        TensorNetwork.__init__(self, tensors, virtual=True, **tn_opts)

    def normalize(self, max_bond=None, cutoff=1e-10, inplace=True,
                  **opts):
        n2 = self.norm2(max_bond=max_bond, cutoff=cutoff, **opts)
        self.multiply_(float(np.real(complex(n2))) ** -0.5)
        return self


class PEPO(TensorNetwork2D):
    """Projected entangled pair operator (reference ``PEPO``
    tn2d/core.py:5068). Array order 'urdlbk' (up right down left
    bra ket)."""

    _EXTRA_PROPS = (
        "_site_tag_id", "_x_tag_id", "_y_tag_id", "_Lx", "_Ly",
        "_upper_ind_id", "_lower_ind_id",
    )

    def __init__(self, arrays, *, shape="urdlbk", tags=None,
                 upper_ind_id="k{},{}", lower_ind_id="b{},{}",
                 site_tag_id="I{},{}", x_tag_id="X{}", y_tag_id="Y{}",
                 **tn_opts):
        if isinstance(arrays, PEPO):
            super().__init__(arrays)
            return
        arrays = tuple(tuple(row) for row in arrays)
        self._Lx = len(arrays)
        self._Ly = len(arrays[0])
        self._upper_ind_id = upper_ind_id
        self._lower_ind_id = lower_ind_id
        self._site_tag_id = site_tag_id
        self._x_tag_id = x_tag_id
        self._y_tag_id = y_tag_id
        tags = tags_to_oset(tags)

        vbonds = [
            [rand_uuid() for _ in range(self._Ly)]
            for _ in range(self._Lx - 1)
        ]
        hbonds = [
            [rand_uuid() for _ in range(self._Ly - 1)]
            for _ in range(self._Lx)
        ]
        tensors = []
        for i, j in itertools.product(range(self._Lx), range(self._Ly)):
            arr = arrays[i][j]
            inds = []
            for c in shape:
                if c == "u" and i < self._Lx - 1:
                    inds.append(vbonds[i][j])
                elif c == "d" and i > 0:
                    inds.append(vbonds[i - 1][j])
                elif c == "r" and j < self._Ly - 1:
                    inds.append(hbonds[i][j])
                elif c == "l" and j > 0:
                    inds.append(hbonds[i][j - 1])
                elif c == "b":
                    inds.append(lower_ind_id.format(i, j))
                elif c == "k":
                    inds.append(upper_ind_id.format(i, j))
            tensors.append(Tensor(
                arr, inds=inds,
                tags=tags | oset((
                    site_tag_id.format(i, j), x_tag_id.format(i),
                    y_tag_id.format(j),
                )),
            ))
        TensorNetwork.__init__(self, tensors, virtual=True, **tn_opts)

    def upper_ind(self, i, j):
        return self._upper_ind_id.format(i, j)

    def lower_ind(self, i, j):
        return self._lower_ind_id.format(i, j)


# ---------------------------------------------------------------------------
# coarse-graining contraction schemes (reference ``contract_hotrg``
# tn2d/core.py:3611, ``contract_ctmrg`` :3801)
# ---------------------------------------------------------------------------


def _compress_merged_bond(tn, tag1, tag2, max_bond, cutoff):
    """Truncate the bond between the sites tagged ``tag1`` and ``tag2``
    after a pairwise merge. A site of a row left unpaired (an odd row
    count) still holds one tensor per layer, and two sites need not share
    a bond: such a pair is left as it is (quimb_tpu skips it by catching
    the errors of ``compress_between``)."""
    tids1 = tn.tag_map.get(tag1, ())
    tids2 = tn.tag_map.get(tag2, ())
    if len(tids1) != 1 or len(tids2) != 1:
        return
    (tid1,), (tid2,) = tids1, tids2
    if not bonds(tn.tensor_map[tid1], tn.tensor_map[tid2]):
        return
    tn._compress_between_tids(tid1, tid2, max_bond=max_bond, cutoff=cutoff)


def _merge_rows_pairwise(tn, max_bond, cutoff):
    """One HOTRG-style coarse-graining step along x: the row pairs
    (2i, 2i+1) merge into one row, then the doubled bonds within each new
    row are truncated back to ``max_bond``."""
    Lx, Ly = tn._Lx, tn._Ly
    new_Lx = (Lx + 1) // 2
    for i in range(new_Lx):
        x0, x1 = 2 * i, 2 * i + 1
        for j in range(Ly):
            t0 = tn.site_tag(x0, j)
            if x1 < Lx:
                t1 = tn.site_tag(x1, j)
                if t0 in tn.tag_map and t1 in tn.tag_map:
                    tn.contract_tags_((t0, t1), which="any")
            # retag to the coarse row
            for tid in tuple(tn.tag_map.get(t0, ())):
                t = tn.tensor_map[tid]
                t.drop_tags((
                    t0, tn.site_tag(x1, j) if x1 < Lx else t0,
                    tn.x_tag(x0), tn.x_tag(x1) if x1 < Lx else tn.x_tag(x0),
                ))
                t.add_tag((tn.site_tag(i, j), tn.x_tag(i), tn.y_tag(j)))
    tn._Lx = new_Lx
    for i in range(new_Lx):
        for j in range(Ly - 1):
            _compress_merged_bond(tn, tn.site_tag(i, j),
                                  tn.site_tag(i, j + 1), max_bond, cutoff)
    return tn


def _merge_cols_pairwise(tn, max_bond, cutoff):
    """The column counterpart of :func:`_merge_rows_pairwise`."""
    Lx, Ly = tn._Lx, tn._Ly
    new_Ly = (Ly + 1) // 2
    for j in range(new_Ly):
        y0, y1 = 2 * j, 2 * j + 1
        for i in range(Lx):
            t0 = tn.site_tag(i, y0)
            if y1 < Ly:
                t1 = tn.site_tag(i, y1)
                if t0 in tn.tag_map and t1 in tn.tag_map:
                    tn.contract_tags_((t0, t1), which="any")
            for tid in tuple(tn.tag_map.get(t0, ())):
                t = tn.tensor_map[tid]
                t.drop_tags((
                    t0, tn.site_tag(i, y1) if y1 < Ly else t0,
                    tn.y_tag(y0), tn.y_tag(y1) if y1 < Ly else tn.y_tag(y0),
                ))
                t.add_tag((tn.site_tag(i, j), tn.x_tag(i), tn.y_tag(j)))
    tn._Ly = new_Ly
    for j in range(new_Ly):
        for i in range(Lx - 1):
            _compress_merged_bond(tn, tn.site_tag(i, j),
                                  tn.site_tag(i + 1, j), max_bond, cutoff)
    return tn


def contract_hotrg(tn, max_bond=None, cutoff=1e-10, inplace=False,
                   equalize_norms=True, **kwargs):
    """Contract a 2D network by alternating HOTRG-style pairwise
    coarse-graining of rows and columns with bond truncation (reference
    ``contract_hotrg`` tn2d/core.py:3611; the truncating projectors come
    from the pairwise bond compression rather than a HOSVD of the
    environment). ``max_bond`` defaults to ``max(8, D**2)``."""
    tn = tn if inplace else tn.copy()
    if max_bond is None:
        max_bond = max(8, (tn.max_bond() or 2) ** 2)
    while (tn._Lx > 1 or tn._Ly > 1) and tn.num_tensors > 4:
        if tn._Lx > 1:
            _merge_rows_pairwise(tn, max_bond, cutoff)
        if equalize_norms:
            tn.equalize_norms_()
        if tn._Ly > 1 and tn.num_tensors > 4:
            _merge_cols_pairwise(tn, max_bond, cutoff)
        if equalize_norms:
            tn.equalize_norms_()
    return tn.contract(...)


def contract_ctmrg(tn, max_bond=None, cutoff=1e-10,
                   sequence=("xmin", "ymin", "xmax", "ymax"), inplace=False,
                   **kwargs):
    """Contract a 2D network on a CTMRG-style schedule: the boundaries
    absorbed inward from all four sides in turn, each absorption followed
    by a compression of the boundary (reference ``contract_ctmrg``
    tn2d/core.py:3801; the corner matrices are the boundary tensors at
    the lattice's corners). ``max_bond`` defaults to ``max(8, D**2)``."""
    tn = tn if inplace else tn.copy()
    if max_bond is None:
        max_bond = max(8, (tn.max_bond() or 2) ** 2)
    return tn.contract_boundary(max_bond=max_bond, cutoff=cutoff,
                                sequence=sequence, inplace=True, **kwargs)


# bind as methods
TensorNetwork2D.contract_hotrg = contract_hotrg
TensorNetwork2D.contract_ctmrg = contract_ctmrg


# ---------------------------------------------------------------------------
# 2D method parity layer (reference tn2d/core.py)
# ---------------------------------------------------------------------------

def _2d_is_cyclic_x(self):
    """Whether there are wrap bonds in the x direction."""
    t0 = self.tag_map.get(self.site_tag(0, 0))
    tl = self.tag_map.get(self.site_tag(self._Lx - 1, 0))
    if not t0 or not tl:
        return False
    from ..core import bonds as _bonds

    return bool(_bonds(
        self.tensor_map[next(iter(t0))],
        self.tensor_map[next(iter(tl))],
    )) and self._Lx > 2


def _2d_is_cyclic_y(self):
    t0 = self.tag_map.get(self.site_tag(0, 0))
    tl = self.tag_map.get(self.site_tag(0, self._Ly - 1))
    if not t0 or not tl:
        return False
    from ..core import bonds as _bonds

    return bool(_bonds(
        self.tensor_map[next(iter(t0))],
        self.tensor_map[next(iter(tl))],
    )) and self._Ly > 2


def _2d_valid_coo(self, coo, xrange=None, yrange=None):
    i, j = coo
    if xrange is not None and not (xrange[0] <= i <= xrange[1]):
        return False
    if yrange is not None and not (yrange[0] <= j <= yrange[1]):
        return False
    return (0 <= i < self._Lx) and (0 <= j < self._Ly)


def _2d_has_site(self, coo):
    return self.site_tag(*coo) in self.tag_map


def _2d_get_ranges_present(self):
    xs, ys = [], []
    for i, j in self.gen_site_coos():
        if self.site_tag(i, j) in self.tag_map:
            xs.append(i)
            ys.append(j)
    return (min(xs), max(xs)), (min(ys), max(ys))


def _mk_bond_gen(steppers, parity=None):
    def gen(self):
        cyc = (self.is_cyclic_x(), self.is_cyclic_y())
        for pair in gen_2d_bonds(
            self._Lx, self._Ly, steppers=steppers, cyclic=cyc
        ):
            if parity is not None:
                (i, j), _ = pair
                if (i + j) % 2 != parity:
                    continue
            yield pair

    return gen


def _2d_gen_pairs(self, xrange=None, yrange=None, xreverse=False,
                  yreverse=False, coordinate_order="xy", xstep=None,
                  ystep=None, stepping_order="xy", step_only=None):
    """All nearest-neighbour coordinate pairs within a range
    (reference ``gen_pairs``)."""
    if xrange is None:
        xrange = (0, self._Lx - 1)
    if yrange is None:
        yrange = (0, self._Ly - 1)
    for i, j in itertools.product(
        range(xrange[0], xrange[1] + 1),
        range(yrange[0], yrange[1] + 1),
    ):
        if i + 1 <= xrange[1]:
            yield ((i, j), (i + 1, j))
        if j + 1 <= yrange[1]:
            yield ((i, j), (i, j + 1))


def _2d_canonize_row(self, i, sweep="right", yrange=None,
                     **canonize_opts):
    """QR-canonize along row ``i`` (reference ``canonize_row``
    tn2d/core.py:973)."""
    if yrange is None:
        yrange = (0, self._Ly - 1)
    js = list(range(yrange[0], yrange[1] + 1))
    if sweep == "left":
        js = js[::-1]
    for ja, jb in zip(js, js[1:]):
        try:
            self.canonize_between(
                self.site_tag(i, ja), self.site_tag(i, jb),
                absorb="right", **canonize_opts,
            )
        except (KeyError, ValueError):
            pass
    return self


def _2d_canonize_column(self, j, sweep="down", xrange=None,
                        **canonize_opts):
    if xrange is None:
        xrange = (0, self._Lx - 1)
    xs = list(range(xrange[0], xrange[1] + 1))
    if sweep in ("up", "left"):
        xs = xs[::-1]
    for xa, xb in zip(xs, xs[1:]):
        try:
            self.canonize_between(
                self.site_tag(xa, j), self.site_tag(xb, j),
                absorb="right", **canonize_opts,
            )
        except (KeyError, ValueError):
            pass
    return self


def _2d_compress_row(self, i, sweep="right", yrange=None,
                     max_bond=None, cutoff=1e-10, **opts):
    """Compress along row ``i`` (reference ``compress_row``)."""
    if yrange is None:
        yrange = (0, self._Ly - 1)
    js = list(range(yrange[0], yrange[1] + 1))
    if sweep == "left":
        js = js[::-1]
    for ja, jb in zip(js, js[1:]):
        try:
            self.compress_between(
                self.site_tag(i, ja), self.site_tag(i, jb),
                max_bond=max_bond, cutoff=cutoff, **opts,
            )
        except (KeyError, ValueError):
            pass
    return self


def _2d_compress_column(self, j, sweep="down", xrange=None,
                        max_bond=None, cutoff=1e-10, **opts):
    if xrange is None:
        xrange = (0, self._Lx - 1)
    xs = list(range(xrange[0], xrange[1] + 1))
    if sweep in ("up", "left"):
        xs = xs[::-1]
    for xa, xb in zip(xs, xs[1:]):
        try:
            self.compress_between(
                self.site_tag(xa, j), self.site_tag(xb, j),
                max_bond=max_bond, cutoff=cutoff, **opts,
            )
        except (KeyError, ValueError):
            pass
    return self


def _2d_canonize_plane(self, xrange, yrange, **opts):
    """Canonize along a plane strip (dispatches on the thin
    direction, reference ``canonize_plane``)."""
    if xrange[0] == xrange[1]:
        return _2d_canonize_row(self, xrange[0], yrange=yrange,
                                **opts)
    return _2d_canonize_column(self, yrange[0], xrange=xrange, **opts)


def _2d_compress_plane(self, xrange, yrange, **opts):
    if xrange[0] == xrange[1]:
        return _2d_compress_row(self, xrange[0], yrange=yrange,
                                **opts)
    return _2d_compress_column(self, yrange[0], xrange=xrange, **opts)


def _2d_canonize_row_around(self, i, around=(0, 1), **opts):
    """Canonize row ``i`` toward the ``around`` columns (reference
    ``canonize_row_around``)."""
    j0, j1 = min(around), max(around)
    _2d_canonize_row(self, i, sweep="right", yrange=(0, j0), **opts)
    _2d_canonize_row(self, i, sweep="left",
                     yrange=(j1, self._Ly - 1), **opts)
    return self


def _2d_compute_environments(self, from_which, **kwargs):
    """Directional environments dispatcher (reference
    ``compute_environments`` tn2d/core.py:2716)."""
    if from_which in ("xmin", "xmax"):
        envs = self.compute_x_environments(**kwargs)
    else:
        envs = self.compute_y_environments(**kwargs)
    return {
        k: v for k, v in envs.items() if k[0] == from_which
    }


def _2d_compute_xmin_environments(self, **kwargs):
    return _2d_compute_environments(self, "xmin", **kwargs)


def _2d_compute_xmax_environments(self, **kwargs):
    return _2d_compute_environments(self, "xmax", **kwargs)


def _2d_compute_ymin_environments(self, **kwargs):
    return _2d_compute_environments(self, "ymin", **kwargs)


def _2d_compute_ymax_environments(self, **kwargs):
    return _2d_compute_environments(self, "ymax", **kwargs)


def _2d_compute_plaquette_environments(self, x_bsz=2, y_bsz=2,
                                       max_bond=None, cutoff=1e-10,
                                       x_envs=None, **opts):
    """Environments of every ``x_bsz x y_bsz`` plaquette: the network
    with the plaquette sites removed, boundary-compressed (reference
    ``compute_plaquette_environments`` tn2d/core.py:3324).

    ``x_envs`` may be passed in to share the (expensive) row
    environments across calls with different plaquette shapes."""
    envs = {}
    if x_envs is None:
        x_envs = self.compute_x_environments(
            max_bond=max_bond, cutoff=cutoff, **opts
        )
    for x0 in range(self._Lx - x_bsz + 1):
        # strip = bottom env + rows [x0, x0+x_bsz) + top env
        strip = TensorNetwork(())
        bot = x_envs.get(("xmin", x0))
        if bot is not None and bot.num_tensors:
            strip.add_tensor_network(bot.copy(), virtual=True,
                                     check_collisions=False)
        for x in range(x0, x0 + x_bsz):
            strip.add_tensor_network(
                self.select(self.x_tag(x), which="any").copy(),
                virtual=True, check_collisions=False,
            )
        top = x_envs.get(("xmax", x0 + x_bsz - 1))
        if top is not None and top.num_tensors:
            strip.add_tensor_network(top.copy(), virtual=True,
                                     check_collisions=False)
        strip.view_like_(self)
        # within-strip left/right column environments via the boundary
        # machinery — it absorbs layer-by-layer (fusing the ket/bra/env
        # tensors sharing a site tag) so the compressions actually
        # apply; the previous ad-hoc sweep hit multi-tensor tags,
        # silently skipped every compression, and left mid-lattice
        # plaquette environments exact (exponentially large)
        y_envs = strip.compute_y_environments(
            max_bond=max_bond, cutoff=cutoff, **opts
        )
        lenvs = {j: y_envs.get(("ymin", j), TensorNetwork(()))
                 for j in range(self._Ly)}
        renvs = {j: y_envs.get(("ymax", j), TensorNetwork(()))
                 for j in range(self._Ly)}
        for y0 in range(self._Ly - y_bsz + 1):
            env = TensorNetwork(())
            le = lenvs.get(y0)
            if le is not None and le.num_tensors:
                env.add_tensor_network(le.copy(), virtual=True,
                                       check_collisions=False)
            re_ = renvs.get(y0 + y_bsz - 1)
            if re_ is not None and re_.num_tensors:
                env.add_tensor_network(re_.copy(), virtual=True,
                                       check_collisions=False)
            # env tensors from the top/bottom rows of the plaquette
            # columns (i.e. strip tensors in those columns NOT at the
            # plaquette coordinates)
            plq_tags = {
                self.site_tag(x0 + dx, y0 + dy)
                for dx in range(x_bsz) for dy in range(y_bsz)
            }
            for j in range(y0, y0 + y_bsz):
                col = strip.select(self.y_tag(j), which="any")
                for t in col.tensor_map.values():
                    if not (plq_tags & set(t.tags)):
                        env.add_tensor(t.copy(), virtual=True)
            envs[(x0, y0), (x_bsz, y_bsz)] = env
    return envs


def _2d_contract_mps_sweep(self, max_bond=None, cutoff=1e-10,
                           direction="xmin", inplace=False, **opts):
    """Contract via a single boundary-MPS sweep across the lattice
    (reference ``contract_mps_sweep``)."""
    tn = self if inplace else self.copy()
    return tn.contract_boundary_from(
        direction, max_bond=max_bond, cutoff=cutoff, inplace=True,
        **opts,
    )


def _2d_coarse_grain_hotrg(self, direction, max_bond=None, cutoff=1e-10,
                           inplace=False, **opts):
    """One HOTRG coarse-graining step along ``direction`` (``"x"`` merges
    row pairs, ``"y"`` column pairs; reference ``coarse_grain_hotrg``)."""
    tn = self if inplace else self.copy()
    if direction in ("x", "xmin", "xmax"):
        return _merge_rows_pairwise(tn, max_bond, cutoff)
    return _merge_cols_pairwise(tn, max_bond, cutoff)


def _2d_flatten(self, fuse_multibonds=True, inplace=False):
    """Contract all layers to one tensor per site (reference
    ``flatten``)."""
    tn = self if inplace else self.copy()
    for i, j in tn.gen_site_coos():
        tag = tn.site_tag(i, j)
        if len(tn.tag_map.get(tag, ())) > 1:
            tn.contract_tags_(tag, which="any")
    if fuse_multibonds:
        tn.fuse_multibonds_()
    return tn


def _wire_2d_parity():
    T2 = TensorNetwork2D
    T2.is_cyclic_x = _2d_is_cyclic_x
    T2.is_cyclic_y = _2d_is_cyclic_y
    T2.valid_coo = _2d_valid_coo
    T2.has_site = _2d_has_site
    T2.get_ranges_present = _2d_get_ranges_present
    T2.gen_pairs = _2d_gen_pairs
    T2.x_tags = property(
        lambda self: tuple(self.x_tag(i) for i in range(self._Lx))
    )
    T2.y_tags = property(
        lambda self: tuple(self.y_tag(j) for j in range(self._Ly))
    )
    T2.row_tags = T2.x_tags
    T2.col_tags = T2.y_tags
    T2.gen_horizontal_bond_coos = _mk_bond_gen(
        [lambda i, j: (i, j + 1)]
    )
    T2.gen_horizontal_even_bond_coos = _mk_bond_gen(
        [lambda i, j: (i, j + 1)], parity=0
    )
    T2.gen_horizontal_odd_bond_coos = _mk_bond_gen(
        [lambda i, j: (i, j + 1)], parity=1
    )
    T2.gen_vertical_bond_coos = _mk_bond_gen(
        [lambda i, j: (i + 1, j)]
    )
    T2.gen_vertical_even_bond_coos = _mk_bond_gen(
        [lambda i, j: (i + 1, j)], parity=0
    )
    T2.gen_vertical_odd_bond_coos = _mk_bond_gen(
        [lambda i, j: (i + 1, j)], parity=1
    )
    T2.gen_diagonal_bond_coos = _mk_bond_gen(
        [lambda i, j: (i + 1, j - 1), lambda i, j: (i + 1, j + 1)]
    )
    T2.gen_diagonal_left_bond_coos = _mk_bond_gen(
        [lambda i, j: (i + 1, j - 1)]
    )
    T2.gen_diagonal_left_even_bond_coos = _mk_bond_gen(
        [lambda i, j: (i + 1, j - 1)], parity=0
    )
    T2.gen_diagonal_left_odd_bond_coos = _mk_bond_gen(
        [lambda i, j: (i + 1, j - 1)], parity=1
    )
    T2.gen_diagonal_right_bond_coos = _mk_bond_gen(
        [lambda i, j: (i + 1, j + 1)]
    )
    T2.gen_diagonal_right_even_bond_coos = _mk_bond_gen(
        [lambda i, j: (i + 1, j + 1)], parity=0
    )
    T2.gen_diagonal_right_odd_bond_coos = _mk_bond_gen(
        [lambda i, j: (i + 1, j + 1)], parity=1
    )
    T2.canonize_row = _2d_canonize_row
    T2.canonize_column = _2d_canonize_column
    T2.canonize_plane = _2d_canonize_plane
    T2.canonize_row_around = _2d_canonize_row_around
    T2.compress_row = _2d_compress_row
    T2.compress_column = _2d_compress_column
    T2.compress_plane = _2d_compress_plane
    T2.compute_environments = _2d_compute_environments
    T2.compute_xmin_environments = _2d_compute_xmin_environments
    T2.compute_xmax_environments = _2d_compute_xmax_environments
    T2.compute_ymin_environments = _2d_compute_ymin_environments
    T2.compute_ymax_environments = _2d_compute_ymax_environments
    T2.compute_plaquette_environments = \
        _2d_compute_plaquette_environments
    T2.contract_mps_sweep = _2d_contract_mps_sweep
    T2.contract_mps_sweep_ = functools.partialmethod(
        _2d_contract_mps_sweep, inplace=True
    )
    T2.coarse_grain_hotrg = _2d_coarse_grain_hotrg
    T2.coarse_grain_hotrg_ = functools.partialmethod(
        _2d_coarse_grain_hotrg, inplace=True
    )
    T2.flatten = _2d_flatten
    T2.flatten_ = functools.partialmethod(_2d_flatten, inplace=True)
    T2.contract_boundary_ = functools.partialmethod(
        T2.contract_boundary, inplace=True
    )
    T2.contract_boundary_from_ = functools.partialmethod(
        T2.contract_boundary_from, inplace=True
    )
    for d in ("xmin", "xmax", "ymin", "ymax"):
        setattr(T2, f"contract_boundary_from_{d}_",
                functools.partialmethod(
                    T2.contract_boundary_from, d, inplace=True,
                ))
    T2.contract_hotrg_ = _noop_inplace_hotrg
    T2.contract_ctmrg_ = _noop_inplace_ctmrg

    def _2d_contract_full_bootstrap(self, n, max_bond=None,
                                    cutoff=1e-10, **kwargs):
        """Contract with successively larger boundary bond dims,
        extrapolating (reference ``contract_full_bootstrap``):
        here simply returns the largest-bond estimate."""
        vals = []
        for k in range(1, n + 1):
            mb = (max_bond or 8) * k
            vals.append(self.contract_boundary(
                max_bond=mb, cutoff=cutoff, **kwargs
            ))
        return vals[-1]

    T2.contract_full_bootstrap = _2d_contract_full_bootstrap

    def show(self):
        for i in range(self._Lx - 1, -1, -1):
            row = ""
            for j in range(self._Ly):
                row += "●" if self.has_site((i, j)) else "○"
                if j < self._Ly - 1:
                    row += "─"
            print(row)

    T2.show = show


def _replace_by_scalar(tn, val):
    """Replace every tensor of ``tn`` by one scalar tensor of ``val``."""
    for tid in tuple(tn.tensor_map):
        tn._pop_tensor(tid)
    tn.add_tensor(Tensor(torch.as_tensor(val)), virtual=True)
    return tn


def _noop_inplace_hotrg(self, **kwargs):
    """In-place HOTRG contraction: the network becomes one scalar tensor
    of its value."""
    return _replace_by_scalar(self, contract_hotrg(self, **kwargs))


def _noop_inplace_ctmrg(self, **kwargs):
    """In-place CTMRG contraction: the network becomes one scalar tensor
    of its value."""
    return _replace_by_scalar(self, contract_ctmrg(self, **kwargs))


_wire_2d_parity()


# -- PEPS constructors / combinators -----------------------------------------

def _wire_peps_constructors():
    from . import builders as _b

    PEPS.rand = classmethod(
        lambda cls, Lx, Ly, bond_dim, **kw: _b.PEPS_rand(
            Lx, Ly, bond_dim, **kw
        )
    )
    PEPS.zeros = classmethod(
        lambda cls, Lx, Ly, bond_dim, **kw: _b.PEPS_zeros(
            Lx, Ly, bond_dim, **kw
        )
    )
    PEPS.empty = PEPS.zeros
    PEPS.product_state = classmethod(
        lambda cls, site_map, **kw: _b.PEPS_product_state(
            site_map, **kw
        )
    )

    def _peps_vacuum(cls, Lx, Ly, phys_dim=2, **kw):
        return _b.PEPS_computational_state(
            "0" * (Lx * Ly), Lx=Lx, Ly=Ly, **kw
        )

    PEPS.vacuum = classmethod(_peps_vacuum)

    def _peps_ones(cls, Lx, Ly, bond_dim, phys_dim=2, dtype=None,
                   device=None, **kw):
        from ...config import get_default_real_dtype
        from ...ops.backend import resolve_device, to_torch_dtype

        dtype = to_torch_dtype(dtype or get_default_real_dtype())
        device = resolve_device(device)
        return _peps_from_fill_fn(
            cls, lambda s: torch.ones(s, dtype=dtype, device=device), Lx,
            Ly, bond_dim, phys_dim=phys_dim, **kw
        )

    def _peps_from_fill_fn(cls, fill_fn, Lx, Ly, bond_dim,
                           phys_dim=2, **kw):
        arrays = []
        for i in range(Lx):
            row = []
            for j in range(Ly):
                shape = []
                if i < Lx - 1:
                    shape.append(bond_dim)
                if j < Ly - 1:
                    shape.append(bond_dim)
                if i > 0:
                    shape.append(bond_dim)
                if j > 0:
                    shape.append(bond_dim)
                shape.append(phys_dim)
                row.append(fill_fn(tuple(shape)))
            arrays.append(row)
        return cls(arrays, shape="urdlp", **kw)

    PEPS.ones = classmethod(_peps_ones)
    PEPS.from_fill_fn = classmethod(_peps_from_fill_fn)

    def _peps_add(self, other, inplace=False, **kwargs):
        """Direct-sum add another PEPS (reference ``add_PEPS``)."""
        from ..tnag.core import tensor_network_ag_sum

        return tensor_network_ag_sum(
            self, other, site_tags=self.site_tags,
            inplace=inplace, **kwargs,
        )

    PEPS.add_PEPS = _peps_add
    PEPS.add_PEPS_ = functools.partialmethod(_peps_add, inplace=True)
    PEPS.__add__ = lambda self, other: _peps_add(self, other)
    PEPS.show = lambda self: TensorNetwork2D.show(self)


_wire_peps_constructors()


# ---------------------------------------------------------------------------
# 2D vector + PEPO parity extras (reference tn2d/core.py:4700-5420)
# ---------------------------------------------------------------------------

def _2dv_reindex_sites(self, new_id, where=None, inplace=False):
    """Change the physical index format (reference
    ``reindex_sites``)."""
    if where is None:
        where = tuple(self.gen_site_coos())
    tn = self if inplace else self.copy()
    tn.reindex_({
        self.site_ind(*c): new_id.format(*c) for c in where
        if self.site_ind(*c) in tn.ind_map
    })
    return tn


def _2dv_compute_norm(self, max_bond=None, cutoff=1e-10, **opts):
    """The 2-norm squared ``<psi|psi>`` via boundary contraction
    (reference ``compute_norm``)."""
    return self.norm2(max_bond=max_bond, cutoff=cutoff, **opts)


def _2dv_normalize(self, max_bond=None, cutoff=1e-10, inplace=False,
                   **opts):
    """Scale so ``<psi|psi> = 1`` within boundary-contraction
    accuracy (reference ``normalize``)."""
    tn = self if inplace else self.copy()
    n2 = _2dv_compute_norm(tn, max_bond=max_bond, cutoff=cutoff,
                           **opts)
    tn.multiply_(float(abs(n2)) ** -0.5, spread_over="all")
    return tn


TensorNetwork2DVector.reindex_sites = _2dv_reindex_sites
TensorNetwork2DVector.reindex_sites_ = functools.partialmethod(
    _2dv_reindex_sites, inplace=True)
TensorNetwork2DVector.compute_norm = _2dv_compute_norm
TensorNetwork2DVector.normalize = _2dv_normalize
TensorNetwork2DVector.normalize_ = functools.partialmethod(
    _2dv_normalize, inplace=True)


def _pepo_from_fill_fn(cls, fill_fn, Lx, Ly, bond_dim, phys_dim=2,
                       **pepo_opts):
    """Build a PEPO by calling ``fill_fn(shape)`` per site (reference
    ``PEPO.from_fill_fn`` tn2d/core.py:5231)."""
    arrays = []
    for i in range(Lx):
        row = []
        for j in range(Ly):
            shape = []
            if i < Lx - 1:
                shape.append(bond_dim)
            if j < Ly - 1:
                shape.append(bond_dim)
            if i > 0:
                shape.append(bond_dim)
            if j > 0:
                shape.append(bond_dim)
            shape += [phys_dim, phys_dim]
            row.append(fill_fn(tuple(shape)))
        arrays.append(row)
    return cls(arrays, shape="urdlbk", **pepo_opts)


def _pepo_rand(cls, Lx, Ly, bond_dim, phys_dim=2, herm=False,
               dtype=None, seed=None, device=None, **pepo_opts):
    """A random (optionally hermitian) PEPO (reference ``PEPO.rand``
    tn2d/core.py:5291), drawn by the port's seeded ``randn`` on
    ``device`` (the GPU unless given)."""
    from ...config import get_default_real_dtype
    from ...gen.rand import randn

    dtype = dtype or get_default_real_dtype()
    counter = itertools.count()

    def fill_fn(shape):
        s = None if seed is None else seed + next(counter)
        X = randn(shape, dtype=dtype, seed=s, device=device)
        if herm:
            X = (X.conj() + X.transpose(-2, -1)) / 2
        return X

    return _pepo_from_fill_fn(cls, fill_fn, Lx, Ly, bond_dim,
                              phys_dim=phys_dim, **pepo_opts)


def _pepo_zeros(cls, Lx, Ly, bond_dim, phys_dim=2, dtype=None,
                device=None, **pepo_opts):
    from ...config import get_default_real_dtype
    from ...ops.backend import resolve_device, to_torch_dtype

    dtype = to_torch_dtype(dtype or get_default_real_dtype())
    device = resolve_device(device)
    return _pepo_from_fill_fn(
        cls, lambda s: torch.zeros(s, dtype=dtype, device=device), Lx, Ly,
        bond_dim, phys_dim=phys_dim, **pepo_opts,
    )


def _pepo_add(self, other, inplace=False):
    """Direct-sum add another PEPO (reference ``add_PEPO``
    tn2d/core.py:5404)."""
    from ..tnag.core import tensor_network_ag_sum

    return tensor_network_ag_sum(
        self, other, site_tags=self.site_tags, inplace=inplace,
    )


PEPO.from_fill_fn = classmethod(_pepo_from_fill_fn)
PEPO.rand = classmethod(_pepo_rand)
def _pepo_rand_herm(cls, *args, **kwargs):
    kwargs.setdefault("herm", True)
    return _pepo_rand(cls, *args, **kwargs)


PEPO.rand_herm = classmethod(_pepo_rand_herm)
PEPO.zeros = classmethod(_pepo_zeros)
PEPO.add_PEPO = _pepo_add
PEPO.add_PEPO_ = functools.partialmethod(_pepo_add, inplace=True)


def _pepo_to_dense(self, *inds_seq, **contract_opts):
    """Dense matrix form, rows indexed by the upper (ket) indices
    (reference ``PEPO.to_dense``)."""
    if not inds_seq:
        coos = tuple(self.gen_site_coos())
        inds_seq = (
            tuple(self.upper_ind(i, j) for i, j in coos),
            tuple(self.lower_ind(i, j) for i, j in coos),
        )
    t = self.contract(
        ..., output_inds=tuple(ix for g in inds_seq for ix in g),
        preserve_tensor=True, **contract_opts,
    )
    d = int(np.prod([self.ind_size(ix) for ix in inds_seq[0]]))
    return t.data.reshape(d, -1)


PEPO.to_dense = _pepo_to_dense


class Rotator2D:
    """Rotate 2D coordinates so directional algorithms are written
    once (reference ``Rotator2D`` tn2d/core.py:204)."""

    def __init__(self, tn, xrange, yrange, from_which, stepsize=1):
        check_opt("from_which", from_which,
                  {"xmin", "xmax", "ymin", "ymax"})
        if xrange is None:
            xrange = (0, tn.Lx - 1)
        if yrange is None:
            yrange = (0, tn.Ly - 1)
        self.tn = tn
        self.xrange = xrange
        self.yrange = yrange
        self.from_which = from_which
        self.plane = from_which[0]
        if self.plane == "x":
            self.imin, self.imax = sorted(xrange)
            self.jmin, self.jmax = sorted(yrange)
            self.x_tag = tn.x_tag
            self.y_tag = tn.y_tag
            self.site_tag = tn.site_tag
            self._cyc_x = tn.is_cyclic_x
            self._cyc_y = tn.is_cyclic_y
        else:
            self.imin, self.imax = sorted(yrange)
            self.jmin, self.jmax = sorted(xrange)
            self.y_tag = tn.x_tag
            self.x_tag = tn.y_tag
            self.site_tag = lambda i, j: tn.site_tag(j, i)
            self._cyc_x = tn.is_cyclic_y
            self._cyc_y = tn.is_cyclic_x
        if "min" in from_which:
            self.sweep = range(self.imin, self.imax + 1, +stepsize)
            self.istep = +stepsize
        else:
            self.sweep = range(self.imax, self.imin - 1, -stepsize)
            self.istep = -stepsize

    @functools.cached_property
    def sweep_other(self):
        return range(self.jmin, self.jmax + 1)

    @functools.cached_property
    def cyclic_x(self):
        return self._cyc_x()

    @functools.cached_property
    def cyclic_y(self):
        return self._cyc_y()

    def get_jnext(self, j):
        if j == self.jmax:
            if self.cyclic_y:
                return self.jmin
            return None
        return j + 1
