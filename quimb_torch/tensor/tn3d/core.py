"""3D tensor networks: ``TensorNetwork3D``, boundary contraction,
``PEPS3D``.

Port of quimb_tpu's ``tensor/tn3d/core.py`` (reference
``quimb/tensor/tn3d/core.py``: ``TensorNetwork3D``, boundary contraction,
``PEPS3D`` :2760). Boundary contraction proceeds plane by plane: each
absorbed plane is a 2D boundary-PEPS whose in-plane bonds are truncated
by pairwise compression, on the device of the network's tensors; the
coarse-graining schemes are ``contract_ctmrg`` (planes absorbed from the
six faces in turn) and ``contract_hotrg`` (pairwise plane merges with
bond truncation).

quimb_tpu skips a plane's site pair by catching the ``KeyError`` and
``ValueError`` of ``compress_between`` / ``canonize_between``; the port
checks the structure instead (:func:`_site_pair_tids`: a site with one
tensor, two sites with a bond), so an error of the split itself reaches
the caller.
"""

import functools
import itertools

import numpy as np
import torch

from ...config import get_default_real_dtype
from ...gen.rand import randn
from ...ops.backend import resolve_device
from ...utils import oset
from ..core import Tensor, TensorNetwork, bonds, rand_uuid
from ..tnag.builders import _on_device


def gen_3d_bonds(Lx, Ly, Lz, steppers=None, coo_filter=None):
    """Generate the nearest-neighbour site pairs of an ``Lx x Ly x Lz``
    cubic lattice (reference ``gen_3d_bonds``)."""
    if steppers is None:
        steppers = [
            lambda i, j, k: (i, j, k + 1),
            lambda i, j, k: (i, j + 1, k),
            lambda i, j, k: (i + 1, j, k),
        ]
    for i, j, k in itertools.product(range(Lx), range(Ly), range(Lz)):
        if coo_filter is None or coo_filter(i, j, k):
            for stepper in steppers:
                i2, j2, k2 = stepper(i, j, k)
                if 0 <= i2 < Lx and 0 <= j2 < Ly and 0 <= k2 < Lz:
                    yield (i, j, k), (i2, j2, k2)


def _site_pair_tids(tn, tag1, tag2):
    """The tensor ids of two sites that each hold one tensor and share a
    bond, else ``None``: a site missing from the network, a site of two
    layers not yet merged (an unpaired plane) and two sites with no bond
    are left as they are, the cases quimb_tpu skips by catching errors."""
    tids1 = tn.tag_map.get(tag1, ())
    tids2 = tn.tag_map.get(tag2, ())
    if len(tids1) != 1 or len(tids2) != 1:
        return None
    (tid1,), (tid2,) = tids1, tids2
    if not bonds(tn.tensor_map[tid1], tn.tensor_map[tid2]):
        return None
    return tid1, tid2


def _compress_site_pair(tn, tag1, tag2, **compress_opts):
    pair = _site_pair_tids(tn, tag1, tag2)
    if pair is not None:
        tn._compress_between_tids(*pair, **compress_opts)


class TensorNetwork3D(TensorNetwork):
    _EXTRA_PROPS = (
        "_site_tag_id", "_x_tag_id", "_y_tag_id", "_z_tag_id",
        "_Lx", "_Ly", "_Lz",
    )

    @property
    def Lx(self):
        return self._Lx

    @property
    def Ly(self):
        return self._Ly

    @property
    def Lz(self):
        return self._Lz

    @property
    def nsites(self):
        return self._Lx * self._Ly * self._Lz

    def site_tag(self, i, j=None, k=None):
        if j is None:
            i, j, k = i
        return self._site_tag_id.format(i, j, k)

    def x_tag(self, i):
        return self._x_tag_id.format(i)

    def y_tag(self, j):
        return self._y_tag_id.format(j)

    def z_tag(self, k):
        return self._z_tag_id.format(k)

    def gen_site_coos(self):
        return itertools.product(
            range(self._Lx), range(self._Ly), range(self._Lz)
        )

    def maybe_convert_coo(self, x):
        if isinstance(x, tuple) and len(x) == 3 and all(
            isinstance(v, (int, np.integer)) for v in x
        ):
            return self.site_tag(*x)
        return x

    def _contract_plane(self, x0, x1, max_bond, cutoff, canonize=True):
        """Absorb x-plane x0 into x1, then compress all bonds within
        the new boundary plane."""
        for j, k in itertools.product(range(self._Ly), range(self._Lz)):
            t0, t1 = self.site_tag(x0, j, k), self.site_tag(x1, j, k)
            if t0 in self.tag_map and t1 in self.tag_map:
                self.contract_tags_((t0, t1), which="any")
            elif t0 in self.tag_map:
                for tid in self.tag_map[t0]:
                    self.tensor_map[tid].add_tag(t1)
        for j, k in itertools.product(range(self._Ly), range(self._Lz)):
            t0, t1 = self.site_tag(x0, j, k), self.site_tag(x1, j, k)
            if t0 in self.tag_map:
                for tid in tuple(self.tag_map[t0]):
                    t = self.tensor_map[tid]
                    t.drop_tags((t0, self.x_tag(x0)))
                    t.add_tag((t1, self.x_tag(x1)))
        if max_bond is not None:
            # compress neighbouring bonds within the plane
            for j, k in itertools.product(range(self._Ly), range(self._Lz)):
                for (j2, k2) in ((j, k + 1), (j + 1, k)):
                    if j2 >= self._Ly or k2 >= self._Lz:
                        continue
                    _compress_site_pair(
                        self, self.site_tag(x1, j, k),
                        self.site_tag(x1, j2, k2),
                        max_bond=max_bond, cutoff=cutoff,
                    )

    def contract_boundary(self, max_bond=None, cutoff=1e-10,
                          inplace=False, **opts):
        """Contract the network plane by plane along x."""
        tn = self if inplace else self.copy()
        for x in range(tn._Lx - 1):
            tn._contract_plane(x, x + 1, max_bond, cutoff)
        return tn.contract(...)


class TensorNetwork3DVector(TensorNetwork3D):
    _EXTRA_PROPS = (
        "_site_tag_id", "_x_tag_id", "_y_tag_id", "_z_tag_id",
        "_Lx", "_Ly", "_Lz", "_site_ind_id",
    )

    def site_ind(self, i, j=None, k=None):
        if j is None:
            i, j, k = i
        return self._site_ind_id.format(i, j, k)

    @property
    def site_inds(self):
        return tuple(
            self.site_ind(*coo) for coo in self.gen_site_coos()
        )

    def phys_dim(self, i=0, j=0, k=0):
        return self.ind_size(self.site_ind(i, j, k))

    def to_dense(self, *inds_seq, **contract_opts):
        if not inds_seq:
            inds_seq = (self.site_inds,)
        t = self.contract(
            ..., output_inds=tuple(
                ix for g in inds_seq for ix in g
            ), preserve_tensor=True, **contract_opts,
        )
        return t.data.reshape(-1, 1)

    def gate(self, G, where, contract="reduce-split", inplace=False,
             **opts):
        from ..gating import tensor_network_gate_inds

        if isinstance(where[0], (int, np.integer)):
            where = (where,)
        inds = tuple(self.site_ind(*coo) for coo in where)
        psi = self if inplace else self.copy()
        if len(inds) == 1:
            contract = True
        tensor_network_gate_inds(
            psi, G, inds, contract=contract, inplace=True, **opts
        )
        return psi

    gate_ = functools.partialmethod(gate, inplace=True)

    def make_norm(self):
        ket = self.copy()
        ket.add_tag("KET")
        bra = ket.H
        bra.retag_({"KET": "BRA"})
        bra.mangle_inner_("*")
        norm = ket & bra
        norm.view_like_(self)
        return norm

    def norm2(self, max_bond=None, cutoff=1e-10, **opts):
        norm = self.make_norm()
        if max_bond is None:
            max_bond = max(8, (self.max_bond() or 2) ** 2)
        return norm.contract_boundary(max_bond=max_bond,
                                      cutoff=cutoff, **opts)


def _bond_inds(i, j, k, Lx, Ly, Lz, bonds_x, bonds_y, bonds_z):
    """The bond indices of site (i, j, k) in the order +x, +y, +z, -x, -y,
    -z, the missing ones dropped."""
    inds = []
    if i + 1 < Lx:
        inds.append(bonds_x[(i, j, k)])
    if j + 1 < Ly:
        inds.append(bonds_y[(i, j, k)])
    if k + 1 < Lz:
        inds.append(bonds_z[(i, j, k)])
    if i > 0:
        inds.append(bonds_x[(i - 1, j, k)])
    if j > 0:
        inds.append(bonds_y[(i, j - 1, k)])
    if k > 0:
        inds.append(bonds_z[(i, j, k - 1)])
    return inds


def _site_shape(i, j, k, Lx, Ly, Lz, bond_dim, phys_dim):
    shape = [bond_dim for cond in (
        i + 1 < Lx, j + 1 < Ly, k + 1 < Lz, i > 0, j > 0, k > 0,
    ) if cond]
    shape.append(phys_dim)
    return tuple(shape)


class PEPS3D(TensorNetwork3DVector):
    """3D PEPS (reference ``PEPS3D`` tn3d/core.py:2760), one bond per
    +x/+y/+z direction; each site's array is ordered (+x, +y, +z, -x, -y,
    -z, p), missing bonds dropped. A torch tensor keeps its device unless
    ``device`` is given; any other array goes to ``device``, the GPU
    unless given."""

    _EXTRA_PROPS = (
        "_site_tag_id", "_x_tag_id", "_y_tag_id", "_z_tag_id",
        "_Lx", "_Ly", "_Lz", "_site_ind_id",
    )

    def __init__(self, arrays=None, *, Lx=None, Ly=None, Lz=None,
                 site_ind_id="k{},{},{}", site_tag_id="I{},{},{}",
                 x_tag_id="X{}", y_tag_id="Y{}", z_tag_id="Z{}",
                 device=None, **tn_opts):
        if hasattr(arrays, "tensor_map"):
            TensorNetwork.__init__(self, arrays)
            return
        arrays = [
            [[arrays[i][j][k] for k in range(len(arrays[0][0]))]
             for j in range(len(arrays[0]))]
            for i in range(len(arrays))
        ]
        self._Lx = Lx = len(arrays)
        self._Ly = Ly = len(arrays[0])
        self._Lz = Lz = len(arrays[0][0])
        self._site_ind_id = site_ind_id
        self._site_tag_id = site_tag_id
        self._x_tag_id = x_tag_id
        self._y_tag_id = y_tag_id
        self._z_tag_id = z_tag_id

        bonds_x, bonds_y, bonds_z = {}, {}, {}
        for i, j, k in itertools.product(range(Lx), range(Ly), range(Lz)):
            if i + 1 < Lx:
                bonds_x[(i, j, k)] = rand_uuid()
            if j + 1 < Ly:
                bonds_y[(i, j, k)] = rand_uuid()
            if k + 1 < Lz:
                bonds_z[(i, j, k)] = rand_uuid()
        tensors = []
        for i, j, k in itertools.product(range(Lx), range(Ly), range(Lz)):
            inds = _bond_inds(i, j, k, Lx, Ly, Lz, bonds_x, bonds_y,
                              bonds_z)
            inds.append(site_ind_id.format(i, j, k))
            tensors.append(Tensor(
                _on_device(arrays[i][j][k], device), inds=inds,
                tags=oset((
                    site_tag_id.format(i, j, k), x_tag_id.format(i),
                    y_tag_id.format(j), z_tag_id.format(k),
                )),
            ))
        TensorNetwork.__init__(self, tensors, virtual=True, **tn_opts)

    @classmethod
    def rand(cls, Lx, Ly, Lz, bond_dim, phys_dim=2, dtype=None,
             seed=None, device=None, **kwargs):
        """Random PEPS3D, each site drawn from a torch generator seeded
        ``seed + s`` (s counting the sites), whose stream differs from
        quimb_tpu's JAX generator: build from a numpy fill function with
        :meth:`from_fill_fn` to share arrays with quimb_tpu."""
        dtype = dtype or get_default_real_dtype()
        device = resolve_device(device)
        arrays = []
        s = 0
        for i in range(Lx):
            pj = []
            for j in range(Ly):
                pk = []
                for k in range(Lz):
                    pk.append(randn(
                        _site_shape(i, j, k, Lx, Ly, Lz, bond_dim,
                                    phys_dim),
                        dtype=dtype, device=device,
                        seed=None if seed is None else seed + s,
                    ))
                    s += 1
                pj.append(pk)
            arrays.append(pj)
        return cls(arrays, **kwargs)


# ---------------------------------------------------------------------------
# 3D method parity layer (reference tn3d/core.py:630-2450)
# ---------------------------------------------------------------------------

_DIR_AXIS = {"x": 0, "y": 1, "z": 2}


def _3d_Ls(tn):
    return (tn._Lx, tn._Ly, tn._Lz)


def _3d_wtag(tn, axis):
    return (tn.x_tag, tn.y_tag, tn.z_tag)[axis]


def _3d_valid_coo(self, coo, xrange=None, yrange=None, zrange=None):
    """Whether ``coo`` lies within the lattice and the given ranges
    (reference ``valid_coo`` tn3d/core.py:648)."""
    for v, rng, L in zip(coo, (xrange, yrange, zrange), _3d_Ls(self)):
        if rng is not None and not (rng[0] <= v <= rng[1]):
            return False
        if not (0 <= v < L):
            return False
    return True


def _3d_has_site(self, coo):
    return self.site_tag(*coo) in self.tag_map


def _3d_gen_bond_coos(self):
    return gen_3d_bonds(self._Lx, self._Ly, self._Lz)


def _3d_get_ranges_present(self):
    """Minimal bounding ranges of sites actually present (reference
    ``get_ranges_present`` tn3d/core.py:672)."""
    xs, ys, zs = [], [], []
    for i, j, k in self.gen_site_coos():
        if self.site_tag(i, j, k) in self.tag_map:
            xs.append(i)
            ys.append(j)
            zs.append(k)
    return (
        (min(xs), max(xs)), (min(ys), max(ys)), (min(zs), max(zs))
    )


def _3d_is_cyclic(self, axis):
    L = _3d_Ls(self)[axis]
    if L <= 2:
        return False
    c0 = [0, 0, 0]
    cl = [0, 0, 0]
    cl[axis] = L - 1
    t0 = self.tag_map.get(self.site_tag(*c0))
    tl = self.tag_map.get(self.site_tag(*cl))
    if not t0 or not tl:
        return False
    return bool(bonds(
        self.tensor_map[next(iter(t0))],
        self.tensor_map[next(iter(tl))],
    ))


def _3d_is_cyclic_x(self, j=None, k=None, imin=None, imax=None):
    return _3d_is_cyclic(self, 0)


def _3d_is_cyclic_y(self, k=None, i=None, jmin=None, jmax=None):
    return _3d_is_cyclic(self, 1)


def _3d_is_cyclic_z(self, i=None, j=None, kmin=None, kmax=None):
    return _3d_is_cyclic(self, 2)


def _3d_flatten(self, fuse_multibonds=True, inplace=False):
    """Contract all layers to one tensor per site (reference
    ``flatten`` tn3d/core.py:794)."""
    tn = self if inplace else self.copy()
    for coo in tn.gen_site_coos():
        tag = tn.site_tag(*coo)
        if len(tn.tag_map.get(tag, ())) > 1:
            tn.contract_tags_(tag, which="any")
    if fuse_multibonds:
        tn.fuse_multibonds_()
    return tn


def _3d_gen_pairs(self, xrange=None, yrange=None, zrange=None,
                  xreverse=False, yreverse=False, zreverse=False,
                  coordinate_order="xyz", xstep=None, ystep=None,
                  zstep=None, stepping_order="xyz", step_only=None):
    """All nearest-neighbour coordinate pairs within a range, in a
    specified sweep and stepping order (reference ``gen_pairs``
    tn3d/core.py:827)."""
    rngs = {
        "x": xrange if xrange is not None else (0, self._Lx - 1),
        "y": yrange if yrange is not None else (0, self._Ly - 1),
        "z": zrange if zrange is not None else (0, self._Lz - 1),
    }
    revs = {"x": xreverse, "y": yreverse, "z": zreverse}
    sweeps = {}
    for w in "xyz":
        lo, hi = min(rngs[w]), max(rngs[w])
        sweeps[w] = (range(hi, lo - 1, -1) if revs[w]
                     else range(lo, hi + 1))
    if step_only is not None:
        stepping_order = stepping_order[step_only]
    steps = {
        "x": xstep if xstep is not None else (-1 if xreverse else 1),
        "y": ystep if ystep is not None else (-1 if yreverse else 1),
        "z": zstep if zstep is not None else (-1 if zreverse else 1),
    }
    order = coordinate_order
    for w in "xyz":
        if w not in order:
            if len(sweeps[w]) > 1:
                raise ValueError(
                    f"'{w}' not in coordinate_order but is not size 1"
                )
            order += w
    xi, yi, zi = map(order.index, "xyz")
    for perm in itertools.product(*(sweeps[w] for w in order)):
        coo_a = (perm[xi], perm[yi], perm[zi])
        for w in stepping_order:
            d = [0, 0, 0]
            d[_DIR_AXIS[w]] = steps[w]
            coo_b = tuple(c + dd for c, dd in zip(coo_a, d))
            if _3d_valid_coo(self, coo_b, rngs["x"], rngs["y"],
                             rngs["z"]):
                yield coo_a, coo_b


def _3d_canonize_plane(self, xrange=None, yrange=None, zrange=None,
                       equalize_norms=False, canonize_opts=None,
                       **gen_pair_opts):
    """Canonize every bond within a subrange (reference
    ``canonize_plane`` tn3d/core.py:935)."""
    canonize_opts = dict(canonize_opts or {})
    canonize_opts.setdefault("absorb", "right")
    for coo_a, coo_b in _3d_gen_pairs(
        self, xrange=xrange, yrange=yrange, zrange=zrange,
        **gen_pair_opts,
    ):
        pair = _site_pair_tids(self, self.site_tag(*coo_a),
                               self.site_tag(*coo_b))
        if pair is not None:
            self._canonize_between_tids(*pair, **canonize_opts)
    return self


def _3d_compress_plane(self, xrange=None, yrange=None, zrange=None,
                       max_bond=None, cutoff=1e-10,
                       equalize_norms=False, compress_opts=None,
                       **gen_pair_opts):
    """Compress every bond within a subrange (reference
    ``compress_plane`` tn3d/core.py:977)."""
    compress_opts = dict(compress_opts or {})
    compress_opts.setdefault("absorb", "both")
    for coo_a, coo_b in _3d_gen_pairs(
        self, xrange=xrange, yrange=yrange, zrange=zrange,
        **gen_pair_opts,
    ):
        _compress_site_pair(
            self, self.site_tag(*coo_a), self.site_tag(*coo_b),
            max_bond=max_bond, cutoff=cutoff, **compress_opts,
        )
    return self


def _plane_coo(axis, p, a, b):
    """The site at coordinate ``p`` along ``axis`` and (a, b) along the
    other two axes, in their order."""
    oth = [ax for ax in range(3) if ax != axis]
    c = [0, 0, 0]
    c[axis], c[oth[0]], c[oth[1]] = p, a, b
    return tuple(c)


def _3d_compress_in_plane(tn, axis, p, max_bond, cutoff):
    """Truncate the bonds between neighbouring sites of plane ``p``."""
    Ls = _3d_Ls(tn)
    na, nb = (Ls[ax] for ax in range(3) if ax != axis)
    for a, b in itertools.product(range(na), range(nb)):
        for a2, b2 in ((a + 1, b), (a, b + 1)):
            if a2 >= na or b2 >= nb:
                continue
            _compress_site_pair(
                tn, tn.site_tag(*_plane_coo(axis, p, a, b)),
                tn.site_tag(*_plane_coo(axis, p, a2, b2)),
                max_bond=max_bond, cutoff=cutoff,
            )


def _3d_absorb_plane(tn, axis, p0, p1, max_bond, cutoff):
    """Absorb the whole plane at coordinate ``p0`` (along ``axis``)
    into the neighbouring plane ``p1``, then truncate the in-plane
    bonds of the merged boundary plane."""
    Ls = _3d_Ls(tn)
    wtag = _3d_wtag(tn, axis)
    na, nb = (Ls[ax] for ax in range(3) if ax != axis)
    for a, b in itertools.product(range(na), range(nb)):
        t0 = tn.site_tag(*_plane_coo(axis, p0, a, b))
        t1 = tn.site_tag(*_plane_coo(axis, p1, a, b))
        if t0 in tn.tag_map and t1 in tn.tag_map:
            tn.contract_tags_((t0, t1), which="any")
        for tid in tuple(tn.tag_map.get(t0, ())):
            t = tn.tensor_map[tid]
            t.drop_tags((t0, wtag(p0)))
            t.add_tag((t1, wtag(p1)))
    if max_bond is not None or cutoff:
        _3d_compress_in_plane(tn, axis, p1, max_bond, cutoff)
    return tn


def _3d_contract_boundary_from(self, from_which, max_bond=None,
                               cutoff=1e-10, xrange=None, yrange=None,
                               zrange=None, inplace=False, **opts):
    """Contract the boundary inward from one of the six faces
    ('xmin'/'xmax'/'ymin'/'ymax'/'zmin'/'zmax'), absorbing plane by
    plane with boundary-PEPS compression (reference
    ``contract_boundary_from`` tn3d/core.py:1327)."""
    tn = self if inplace else self.copy()
    w = from_which[0]
    axis = _DIR_AXIS[w]
    rng = {"x": xrange, "y": yrange, "z": zrange}[w]
    if rng is None:
        rng = (0, _3d_Ls(tn)[axis] - 1)
    if from_which.endswith("min"):
        pairs = [(p, p + 1) for p in range(rng[0], rng[1])]
    else:
        pairs = [(p, p - 1) for p in range(rng[1], rng[0], -1)]
    for p0, p1 in pairs:
        _3d_absorb_plane(tn, axis, p0, p1, max_bond, cutoff)
    return tn


def _3d_contract_boundary(self, max_bond=None, cutoff=1e-10,
                          sequence=None, inplace=False, **opts):
    """Contract the network boundary-inward. With ``sequence`` given,
    cycle through faces CTMRG-style; otherwise sweep plane by plane
    along x (reference ``contract_boundary`` tn3d/core.py:1531)."""
    tn = self if inplace else self.copy()
    if sequence is None:
        for x in range(tn._Lx - 1):
            tn._contract_plane(x, x + 1, max_bond, cutoff)
        return tn.contract(...)
    ranges = {
        "x": [0, tn._Lx - 1],
        "y": [0, tn._Ly - 1],
        "z": [0, tn._Lz - 1],
    }
    progress = True
    while progress:
        progress = False
        for from_which in sequence:
            if tn.num_tensors <= 2:
                # the final merge would empty the network: leave it to
                # the closing exact contraction
                progress = False
                break
            w = from_which[0]
            lo, hi = ranges[w]
            if hi <= lo:
                continue
            axis = _DIR_AXIS[w]
            if from_which.endswith("min"):
                _3d_absorb_plane(tn, axis, lo, lo + 1, max_bond, cutoff)
                ranges[w][0] += 1
            else:
                _3d_absorb_plane(tn, axis, hi, hi - 1, max_bond, cutoff)
                ranges[w][1] -= 1
            progress = True
    return tn.contract(...)


def _3d_contract_peps_sweep(self, max_bond=None, cutoff=1e-10,
                            direction="xmin", **opts):
    """Contract by sweeping a boundary PEPS across the lattice
    (reference ``contract_peps_sweep`` tn3d/core.py:1716)."""
    if max_bond is None:
        max_bond = max(8, (self.max_bond() or 2) ** 2)
    tn = _3d_contract_boundary_from(
        self, direction, max_bond=max_bond, cutoff=cutoff,
        inplace=False, **opts,
    )
    return tn.contract(...)


def _3d_contract_simple_sweep(self, max_bond=None, cutoff=1e-10,
                              gauges=None, **opts):
    """Contract by first simple-update gauging all bonds, then
    sweeping a boundary PEPS (reference ``contract_simple_sweep``
    tn3d/core.py:1824)."""
    tn = self.copy()
    gauges = {} if gauges is None else gauges
    tn.gauge_all_simple_(gauges=gauges)
    # the gauges live outside the gauged network: reinsert them so the
    # sweep contracts the original value (in the better-conditioned
    # superorthogonal basis)
    tn.gauge_simple_insert(gauges)
    return _3d_contract_peps_sweep(tn, max_bond=max_bond,
                                   cutoff=cutoff, **opts)


def _3d_contract_ctmrg(self, max_bond=None, cutoff=1e-10,
                       sequence=("xmin", "ymin", "zmin", "xmax",
                                 "ymax", "zmax"),
                       inplace=False, **opts):
    """Contract with a CTMRG-style rotating-face schedule (reference
    ``contract_ctmrg`` tn3d/core.py:1871)."""
    if max_bond is None:
        max_bond = max(8, (self.max_bond() or 2) ** 2)
    return _3d_contract_boundary(
        self, max_bond=max_bond, cutoff=cutoff, sequence=sequence,
        inplace=inplace, **opts,
    )


def _3d_merge_planes_pairwise(tn, axis, max_bond, cutoff):
    """One HOTRG coarse-graining step: plane pairs (2p, 2p+1) along
    ``axis`` merge into one plane, then the doubled transverse bonds
    are truncated."""
    Ls = _3d_Ls(tn)
    L = Ls[axis]
    new_L = (L + 1) // 2
    wtag = _3d_wtag(tn, axis)
    na, nb = (Ls[ax] for ax in range(3) if ax != axis)
    for p in range(new_L):
        p0, p1 = 2 * p, 2 * p + 1
        for a, b in itertools.product(range(na), range(nb)):
            t0 = tn.site_tag(*_plane_coo(axis, p0, a, b))
            if p1 < L:
                t1 = tn.site_tag(*_plane_coo(axis, p1, a, b))
                if t0 in tn.tag_map and t1 in tn.tag_map:
                    tn.contract_tags_((t0, t1), which="any")
            for tid in tuple(tn.tag_map.get(t0, ())):
                t = tn.tensor_map[tid]
                drop = [t0, wtag(p0)]
                if p1 < L:
                    drop += [tn.site_tag(*_plane_coo(axis, p1, a, b)),
                             wtag(p1)]
                t.drop_tags(drop)
                t.add_tag((tn.site_tag(*_plane_coo(axis, p, a, b)),
                           wtag(p)))
    setattr(tn, ("_Lx", "_Ly", "_Lz")[axis], new_L)
    for p in range(new_L):
        _3d_compress_in_plane(tn, axis, p, max_bond, cutoff)
    return tn


def _3d_coarse_grain_hotrg(self, direction, max_bond=None,
                           cutoff=1e-10, inplace=False, **opts):
    """One HOTRG coarse-graining step along ``direction`` (reference
    ``coarse_grain_hotrg`` tn3d/core.py:2192; the truncating projectors
    come from pairwise bond compression rather than a full HOSVD
    environment)."""
    tn = self if inplace else self.copy()
    return _3d_merge_planes_pairwise(
        tn, _DIR_AXIS[direction[0]], max_bond, cutoff
    )


def _3d_contract_hotrg(self, max_bond=None, cutoff=1e-10,
                       inplace=False, equalize_norms=True, **opts):
    """Contract by alternately HOTRG coarse-graining x, y and z until
    the lattice is trivial (reference ``contract_hotrg``
    tn3d/core.py:2379)."""
    tn = self if inplace else self.copy()
    if max_bond is None:
        max_bond = max(8, (tn.max_bond() or 2) ** 2)
    while (
        (tn._Lx > 1 or tn._Ly > 1 or tn._Lz > 1)
        and tn.num_tensors > 8
    ):
        for axis in (0, 1, 2):
            if _3d_Ls(tn)[axis] > 1:
                _3d_merge_planes_pairwise(tn, axis, max_bond, cutoff)
            if equalize_norms:
                tn.equalize_norms_()
    return tn.contract(...)


def _wire_3d_parity():
    T3 = TensorNetwork3D
    T3.x_tag_id = property(lambda self: self._x_tag_id)
    T3.y_tag_id = property(lambda self: self._y_tag_id)
    T3.z_tag_id = property(lambda self: self._z_tag_id)
    T3.x_tags = property(lambda self: tuple(
        self.x_tag(i) for i in range(self._Lx)))
    T3.y_tags = property(lambda self: tuple(
        self.y_tag(j) for j in range(self._Ly)))
    T3.z_tags = property(lambda self: tuple(
        self.z_tag(k) for k in range(self._Lz)))
    T3.valid_coo = _3d_valid_coo
    T3.has_site = _3d_has_site
    T3.gen_bond_coos = _3d_gen_bond_coos
    T3.get_ranges_present = _3d_get_ranges_present
    T3.is_cyclic_x = _3d_is_cyclic_x
    T3.is_cyclic_y = _3d_is_cyclic_y
    T3.is_cyclic_z = _3d_is_cyclic_z
    T3.flatten = _3d_flatten
    T3.flatten_ = functools.partialmethod(_3d_flatten, inplace=True)
    T3.gen_pairs = _3d_gen_pairs
    T3.canonize_plane = _3d_canonize_plane
    T3.compress_plane = _3d_compress_plane
    T3.contract_boundary_from = _3d_contract_boundary_from
    T3.contract_boundary_from_ = functools.partialmethod(
        _3d_contract_boundary_from, inplace=True)
    T3.contract_boundary = _3d_contract_boundary
    T3.contract_boundary_ = functools.partialmethod(
        _3d_contract_boundary, inplace=True)
    T3.contract_peps_sweep = _3d_contract_peps_sweep
    T3.contract_simple_sweep = _3d_contract_simple_sweep
    T3.contract_ctmrg = _3d_contract_ctmrg
    T3.contract_ctmrg_ = functools.partialmethod(
        _3d_contract_ctmrg, inplace=True)
    T3.coarse_grain_hotrg = _3d_coarse_grain_hotrg
    T3.coarse_grain_hotrg_ = functools.partialmethod(
        _3d_coarse_grain_hotrg, inplace=True)
    T3.contract_hotrg = _3d_contract_hotrg
    T3.contract_hotrg_ = functools.partialmethod(
        _3d_contract_hotrg, inplace=True)


_wire_3d_parity()


# ---------------------------------------------------------------------------
# 3D vector / PEPS3D parity extras (reference tn3d/core.py:2760-3400)
# ---------------------------------------------------------------------------

def _3dv_reindex_sites(self, new_id, where=None, inplace=False):
    """Change the physical index format (reference ``reindex_sites``)."""
    if where is None:
        where = tuple(self.gen_site_coos())
    tn = self if inplace else self.copy()
    tn.reindex_({
        self.site_ind(*c): new_id.format(*c) for c in where
        if self.site_ind(*c) in tn.ind_map
    })
    return tn


TensorNetwork3DVector.reindex_sites = _3dv_reindex_sites
TensorNetwork3DVector.reindex_sites_ = functools.partialmethod(
    _3dv_reindex_sites, inplace=True)


def _p3d_from_fill_fn(cls, fill_fn, Lx, Ly, Lz, bond_dim, phys_dim=2,
                      device=None, **kwargs):
    """Build a PEPS3D by calling ``fill_fn(shape)`` per site; bond order
    (+x, +y, +z, -x, -y, -z, p), missing bonds dropped (reference
    ``PEPS3D.from_fill_fn`` tn3d/core.py:2865). Host arrays go to
    ``device``, the GPU unless given."""
    arrays = [[[fill_fn(_site_shape(i, j, k, Lx, Ly, Lz, bond_dim,
                                     phys_dim))
                for k in range(Lz)] for j in range(Ly)] for i in range(Lx)]
    return cls(arrays, device=device, **kwargs)


def _p3d_ones(cls, Lx, Ly, Lz, bond_dim, phys_dim=2, device=None,
              **kwargs):
    device = resolve_device(device)
    return _p3d_from_fill_fn(
        cls, lambda s: torch.ones(s, dtype=get_default_real_dtype(),
                                  device=device),
        Lx, Ly, Lz, bond_dim, phys_dim=phys_dim, **kwargs,
    )


def _p3d_empty(cls, Lx, Ly, Lz, bond_dim, phys_dim=2, device=None,
               **kwargs):
    device = resolve_device(device)
    return _p3d_from_fill_fn(
        cls, lambda s: torch.zeros(s, dtype=get_default_real_dtype(),
                                   device=device),
        Lx, Ly, Lz, bond_dim, phys_dim=phys_dim, **kwargs,
    )


def _p3d_permute_arrays(self, shape="xyzXYZp"):
    """Transpose each site tensor's axes to a canonical direction
    order: 'x','y','z' are the +direction bonds, 'X','Y','Z' the
    -direction bonds and 'p' the physical index (reference
    ``permute_arrays``, whose array convention has 'urfdlbp' labels)."""
    for (i, j, k) in self.gen_site_coos():
        tids = self.tag_map.get(self.site_tag(i, j, k), ())
        if len(tids) != 1:
            continue
        t = self.tensor_map[next(iter(tids))]
        dir_ind = {"p": self.site_ind(i, j, k)}
        for key, coo in (
            ("x", (i + 1, j, k)), ("y", (i, j + 1, k)),
            ("z", (i, j, k + 1)), ("X", (i - 1, j, k)),
            ("Y", (i, j - 1, k)), ("Z", (i, j, k - 1)),
        ):
            ntids = self.tag_map.get(self.site_tag(*coo), ())
            if len(ntids) == 1:
                nt = self.tensor_map[next(iter(ntids))]
                shared = [ix for ix in t.inds if ix in nt.inds]
                if shared:
                    dir_ind[key] = shared[0]
        order = tuple(dir_ind[c] for c in shape if c in dir_ind)
        if set(order) == set(t.inds):
            t.transpose_(*order)
    return self


def _p3d_expec_tn(ket, G, where):
    """Sandwich TN ``<psi| G_where |psi>`` with the gate applied to
    the ket."""
    kG = ket.gate(G, where) if G is not None else ket.copy()
    kG.add_tag("KET")
    bra = ket.H
    bra.add_tag("BRA")
    bra.mangle_inner_("*")
    tn = kG | bra
    tn.view_like_(ket)
    return tn


def _p3d_compute_local_expectation(self, terms, max_bond=None,
                                   cutoff=1e-10, normalized=True,
                                   return_all=False, **opts):
    """Sum of local expectations ``<psi|G|psi>`` for ``terms``, a map
    ``{where: G}``, each via boundary contraction of the gated
    sandwich network (reference ``compute_local_expectation``
    tn3d/core.py:3130)."""
    if max_bond is None:
        max_bond = max(8, (self.max_bond() or 2) ** 2)
    results = {}
    for where, G in terms.items():
        expec = _p3d_expec_tn(self, G, where).contract_boundary(
            max_bond=max_bond, cutoff=cutoff, **opts,
        )
        if normalized:
            nrm = _p3d_expec_tn(self, None, where).contract_boundary(
                max_bond=max_bond, cutoff=cutoff, **opts,
            )
            expec = expec / nrm
        results[where] = expec
    if return_all:
        return results
    return sum(results.values())


def _p3d_cluster(self, where, max_distance=1):
    """The tensors within graph distance ``max_distance`` of the ``where``
    site tensors, as a network of copies."""
    tids = set()
    for coo in where:
        tids |= set(self.tag_map.get(self.site_tag(*coo), ()))
    frontier = set(tids)
    for _ in range(max_distance):
        new = set()
        for tid in frontier:
            for ix in self.tensor_map[tid].inds:
                new |= set(self.ind_map.get(ix, ()))
        new -= tids
        tids |= new
        frontier = new
    return TensorNetwork([self.tensor_map[tid].copy() for tid in tids])


def _rho_of(self, ket, kix, **contract_opts):
    """The normalised dense density matrix of the open network ``ket`` on
    the site indices ``kix``."""
    bra = ket.conj()
    bix = {ix: ix + "__b__" for ix in kix}
    bra.reindex_(bix)
    bra.mangle_inner_("*")
    rho_tn = TensorNetwork((ket, bra), virtual=True)
    t = rho_tn.contract(
        ..., output_inds=(*kix, *bix.values()),
        preserve_tensor=True, **contract_opts,
    )
    d = int(np.prod([self.ind_size(ix) for ix in kix]))
    rho = t.data.reshape(d, d)
    return rho / torch.trace(rho)


def _p3d_partial_trace_cluster(self, keep, max_distance=1,
                               **contract_opts):
    """Reduced density matrix from the local cluster around ``keep``
    (reference ``partial_trace_cluster``)."""
    keep = tuple(keep)
    if keep and isinstance(keep[0], (int, np.integer)):
        keep = (keep,)
    cluster = _p3d_cluster(self, keep, max_distance=max_distance)
    return _rho_of(self, cluster, [self.site_ind(*c) for c in keep],
                   **contract_opts)


def _p3d_partial_trace(self, keep, max_bond=None, cutoff=1e-10,
                       method="exact", **contract_opts):
    """Dense reduced density matrix of the ``keep`` sites (reference
    ``partial_trace`` tn3d/core.py:3060)."""
    keep = tuple(keep)
    if keep and isinstance(keep[0], (int, np.integer)):
        keep = (keep,)
    if method == "cluster":
        return _p3d_partial_trace_cluster(self, keep, **contract_opts)
    return _rho_of(self, self.copy(), [self.site_ind(*c) for c in keep],
                   **contract_opts)


PEPS3D.from_fill_fn = classmethod(_p3d_from_fill_fn)
PEPS3D.ones = classmethod(_p3d_ones)
PEPS3D.empty = classmethod(_p3d_empty)
PEPS3D.permute_arrays = _p3d_permute_arrays
PEPS3D.compute_local_expectation = _p3d_compute_local_expectation
PEPS3D.partial_trace = _p3d_partial_trace
PEPS3D.partial_trace_cluster = _p3d_partial_trace_cluster
