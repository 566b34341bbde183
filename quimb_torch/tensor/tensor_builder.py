"""Generic / random / combinatorial tensor-network builders.

Port of quimb_tpu's ``tensor/tensor_builder.py``, which completes the
builder surface of reference ``quimb/tensor/tensor_builder.py`` beyond the
geometry-specific modules (``tn1d.builders``, ``tn2d.builders``,
``tnag.builders``): random tensors (:78, :126, :150), site / string / graph
TN factories (:237, :719, :902, :4063), 2D / 3D scalar lattices
(:1294-2318), classical Ising partition functions in direct and hyper
form (:2364-3425), and SAT / model-counting instances (:3869-4062).

The structural (set-up) array work runs on the host in numpy: these
tensors are tiny. Every builder takes ``device`` and puts its tensors on
the GPU unless given another; an array that a fill function returns as a
tensor keeps its device when ``device`` is not given. The random builders
draw from :func:`quimb_torch.gen.rand.get_rand_fill_fn`, a torch generator
whose stream differs from quimb_tpu's JAX generator: build from a numpy
``fill_fn`` (the ``*_from_fill_fn`` builders) to share arrays with
quimb_tpu.
The ``np.random.default_rng`` streams (rewiring, random graphs and k-SAT
instances) are quimb_tpu's.
"""

import collections
import functools
import itertools
import math

import numpy as np
import torch

from ..config import get_default_dtype
from ..gen.rand import get_rand_fill_fn, rand_phase, randn
from ..ops.backend import resolve_device, to_device, to_host, to_torch_dtype
from ..ops.contraction import array_contract
from .core import (
    Tensor,
    TensorNetwork,
    new_bond,
    rand_uuid,
    tags_to_oset,
    tensor_network_sum,
)
from .tn2d.core import TensorNetwork2D, gen_2d_bonds
from .tn3d.core import TensorNetwork3D, gen_3d_bonds
from .tnag.builders import (
    HTN_from_clauses,
    TN_from_edges_and_fill_fn,
    TN_from_edges_rand,
    _on_device,
    classical_ising_H_matrix,
    classical_ising_S_matrix,
    cnf_file_parse,
)
from .tnag.core import (
    LatticeBondMap,
    TensorNetworkGen,
    TensorNetworkGenVector,
    create_lazy_edge_map,
)

_HOST = torch.device("cpu")


def _host_S(beta, j):
    return to_host(classical_ising_S_matrix(beta, j=j, device=_HOST))


def _host_H(beta, h):
    return to_host(classical_ising_H_matrix(beta, h=h, device=_HOST))


# ---------------------------------------------------------------------------
# random tensors (reference tensor_builder.py:55-237)
# ---------------------------------------------------------------------------

def delta_array(shape, dtype="float64"):
    """The COPY/delta tensor as a host array: 1 where all indices are
    equal (reference ``delta_array`` tensor_builder.py:55)."""
    x = np.zeros(shape, dtype=dtype)
    idx = np.indices(x.shape)
    x[(idx[0] == idx).all(axis=0)] = 1
    return x


def rand_tensor(shape, inds, tags=None, dtype=None, dist="normal",
                scale=1.0, loc=0.0, left_inds=None, seed=None,
                device=None, **randn_opts):
    """Random tensor with given shape/inds (reference ``rand_tensor``
    tensor_builder.py:78)."""
    dtype = dtype or "float64"
    data = randn(tuple(shape), dtype=dtype, dist=dist, scale=scale,
                 loc=loc, seed=seed, device=device, **randn_opts)
    return Tensor(data, inds=inds, tags=tags, left_inds=left_inds)


def rand_phased(shape, inds, tags=None, dtype="complex128", seed=None,
                device=None):
    """Random tensor with unit-circle phased entries, so
    ``T.H @ T == T.size`` (reference ``rand_phased``
    tensor_builder.py:126)."""
    data = rand_phase(tuple(shape), dtype=dtype, seed=seed, device=device)
    return Tensor(data, inds=inds, tags=tags)


def rand_symmetric_array(d, ndim, dist="normal", loc=0.0, scale=1.0,
                         seed=None, dtype="float64", fill_fn=None):
    """Random index-permutation-invariant host array (reference
    ``rand_symmetric_array`` tensor_builder.py:150): one draw of
    ``fill_fn(())`` per multiset of index values."""
    if fill_fn is None:
        fill_fn = get_rand_fill_fn(dist=dist, loc=loc, scale=scale,
                                   seed=seed, dtype=dtype, device=_HOST)
    value_store = {}
    x = np.empty((d,) * ndim, dtype=dtype)
    for coo in itertools.product(range(d), repeat=ndim):
        key = [0] * d
        for i in coo:
            key[i] += 1
        key = tuple(key)
        if key not in value_store:
            value_store[key] = to_host(fill_fn(()))
        x[coo] = value_store[key]
    return x


def rand_tensor_symmetric(d, inds, tags=None, dist="normal", loc=0.0,
                          scale=1.0, seed=None, device=None):
    """Random permutation-symmetric tensor (reference
    ``rand_tensor_symmetric`` tensor_builder.py:204)."""
    data = rand_symmetric_array(d, len(inds), dist=dist, loc=loc,
                                scale=scale, seed=seed)
    return Tensor(to_device(data, device=resolve_device(device)),
                  inds=inds, tags=tags)


# ---------------------------------------------------------------------------
# site / edge / string TN factories
# ---------------------------------------------------------------------------

def TN_from_sites_product_state(site_map, site_tag_id="I{}",
                                site_ind_id="k{}", device=None):
    """A product state in general TN form from ``{site: local vector}``
    (reference ``TN_from_sites_product_state``
    tensor_builder.py:237)."""
    sites = tuple(sorted(site_map))
    tn = TensorNetwork([
        Tensor(_on_device(site_map[site], device),
               inds=(site_ind_id.format(site),),
               tags=(site_tag_id.format(site),))
        for site in sites
    ], virtual=True)
    return tn.view_as_(
        TensorNetworkGenVector, sites=sites, site_tag_id=site_tag_id,
        site_ind_id=site_ind_id,
    )


def TN_from_sites_computational_state(site_map, site_tag_id="I{}",
                                      site_ind_id="k{}",
                                      dtype="float64", device=None):
    """A computational basis state in general TN form from
    ``{site: '0'|'1'|'+'|'-'}`` (reference
    ``TN_from_sites_computational_state`` tensor_builder.py:274)."""
    array_map = {
        "0": np.array([1.0, 0.0], dtype=dtype),
        "1": np.array([0.0, 1.0], dtype=dtype),
        "+": np.array([2**-0.5, 2**-0.5], dtype=dtype),
        "-": np.array([2**-0.5, -(2**-0.5)], dtype=dtype),
    }
    return TN_from_sites_product_state(
        {k: array_map[v] for k, v in site_map.items()},
        site_tag_id=site_tag_id, site_ind_id=site_ind_id,
        device=resolve_device(device),
    )


def gen_unique_edges(edges):
    """Canonically ordered unique edges (reference ``gen_unique_edges``
    tensor_builder.py:311)."""
    seen = set()
    for node_a, node_b in edges:
        if str(node_b) < str(node_a):
            node_a, node_b = node_b, node_a
        key = (node_a, node_b)
        if key in seen:
            continue
        yield key
        seen.add(key)


def compute_string_edge_frequencies(strings):
    """Count how often each canonical edge appears in ``strings``
    (reference ``compute_string_edge_frequencies``
    tensor_builder.py:335)."""
    freqs = collections.defaultdict(int)
    for string in strings:
        for cooa, coob in zip(string, string[1:]):
            key = tuple(sorted((cooa, coob)))
            freqs[key] += 1
    return freqs


def _value_fill(value, dtype):
    element = np.array(value, dtype=dtype)

    def fill_fn(shape):
        return np.broadcast_to(element, shape).copy()

    return fill_fn


def TN_from_edges_with_value(value, edges, D, phys_dim=None,
                             site_tag_id="I{}", site_ind_id="k{}",
                             dtype=None, device=None):
    """Graph TN with every tensor element set to ``value`` (reference
    ``TN_from_edges_with_value`` tensor_builder.py:502)."""
    return TN_from_edges_and_fill_fn(
        _value_fill(value, dtype), edges, D, phys_dim=phys_dim,
        site_tag_id=site_tag_id, site_ind_id=site_ind_id,
        device=resolve_device(device),
    )


def TN_rand_tree(n, D, phys_dim=None, max_degree=None, seed=None,
                 dtype="float64", site_tag_id="I{}",
                 site_ind_id="k{}", device=None, **randn_opts):
    """Random tree TN (reference ``TN_rand_tree``
    tensor_builder.py:664): quimb_tpu's tree (``edges_tree_rand`` draws
    from numpy), the port's arrays."""
    from .geometry import edges_tree_rand

    edges = edges_tree_rand(n, max_degree=max_degree, seed=seed)
    return TN_from_edges_rand(
        edges, D, phys_dim=phys_dim, seed=seed, dtype=dtype,
        site_tag_id=site_tag_id, site_ind_id=site_ind_id, device=device,
        **randn_opts,
    )


def TN_from_strings(strings, fill_fn=None, line_dim=2,
                    allow_plaquettes=True, site_tag_id="I{}",
                    random_rewire=False, random_rewire_seed=None,
                    join=False, join_avoid_self_loops=True,
                    normalize=False, contract_sites=True,
                    fuse_multibonds=True, device=None, **contract_opts):
    """TN from strings of connected sites: each string becomes a line
    (or plaquette loop) of ``line_dim`` matrices, sharing site tags
    where strings cross (reference ``TN_from_strings``
    tensor_builder.py:719)."""
    if fill_fn is None:
        fill_fn = delta_array

    def fill(shape):
        return _on_device(fill_fn(shape), device)

    sites = tuple(sorted(set.union(*map(set, strings))))
    tn = TensorNetwork([], virtual=True)

    for string in strings:
        string_inds = collections.defaultdict(rand_uuid)
        is_plaquette = allow_plaquettes and (string[0] == string[-1])
        if is_plaquette:
            string = (*string, string[1])
        else:
            tn.add_tensor(Tensor(
                fill((line_dim,)),
                inds=(string_inds[tuple(sorted((string[0], string[1])))],),
                tags=(site_tag_id.format(string[0]),),
            ), virtual=True)
        for i in range(1, len(string) - 1):
            tn.add_tensor(Tensor(
                fill((line_dim, line_dim)),
                inds=(
                    string_inds[tuple(sorted((string[i - 1], string[i])))],
                    string_inds[tuple(sorted((string[i], string[i + 1])))],
                ),
                tags=(site_tag_id.format(string[i]),),
            ), virtual=True)
        if not is_plaquette:
            tn.add_tensor(Tensor(
                fill((line_dim,)),
                inds=(string_inds[tuple(sorted((string[-2], string[-1])))],),
                tags=(site_tag_id.format(string[-1]),),
            ), virtual=True)

    tn.view_as_(TensorNetworkGen, sites=sites, site_tag_id=site_tag_id)

    if random_rewire:
        rng = np.random.default_rng(random_rewire_seed)
        for tag in tn.site_tags:
            stn = tn.select(tag)
            inds = tuple(stn.all_inds())
            new_inds = tuple(rng.permutation(inds))
            # two-step reindex to avoid collisions during permutation
            tmp = {ix: rand_uuid() for ix in inds}
            stn.reindex_(tmp)
            stn.reindex_(dict(zip(tmp.values(), new_inds)))

    # site pairs each index touches (for self-loop avoidance)
    ind_locs = {}
    for tag in tn.site_tags:
        for ix in tn.select(tag).all_inds():
            ind_locs.setdefault(ix, set()).add(tag)

    if join:
        for tag in tn.site_tags:
            stn = tn.select(tag)
            ts = [t for t in stn.tensor_map.values() if t.ndim == 1]
            while len(ts) > 1:
                ta = ts.pop(0)
                if join_avoid_self_loops:
                    i = next(
                        (i for i, t in enumerate(ts)
                         if ind_locs[ta.inds[0]] != ind_locs[t.inds[0]]),
                        0,
                    )
                else:
                    i = 0
                tb = ts.pop(i)
                new_bond(ta, tb, size=line_dim)
                ta.modify(data=fill(ta.shape))
                tb.modify(data=fill(tb.shape))
            if (join == "all") and ts:
                (ta,) = ts
                others = [
                    t for t in stn.tensor_map.values() if t is not ta
                ]
                if others:
                    tb = others[0]
                    new_bond(ta, tb, size=line_dim)
                    ta.modify(data=fill(ta.shape))
                    tb.modify(data=fill(tb.shape))

    if normalize:
        sign = 1.0
        for tn_i in tn.subgraphs():
            tn_i = tn_i.rank_simplify()
            z_i = complex(tn_i.contract(**contract_opts)).real
            sign *= math.copysign(1.0, z_i)
            tn.exponent -= math.log10(abs(z_i))
        if sign < 0:
            next(iter(tn.tensor_map.values())).modify(
                apply=lambda x: -x
            )
        tn.distribute_exponent()

    if contract_sites:
        for tag in tn.site_tags:
            if len(tn.tag_map.get(tag, ())) > 1:
                tn.contract_tags_(tag, which="any")
        if fuse_multibonds:
            tn.fuse_multibonds_()

    return tn


def HTN_rand(n, reg, n_out=0, n_hyper_in=0, n_hyper_out=0, d_min=2,
             d_max=3, seed=None, dtype="float64", dist="normal",
             scale=1.0, loc=0.0, site_ind_id="k{}", device=None):
    """Random (hyper) tensor network with a mix of normal and hyper
    inner/outer indices, edge-case fodder for contraction tests
    (reference ``HTN_rand`` tensor_builder.py:902, which defers to
    cotengra's ``rand_equation``; quimb_tpu's native form). The structure
    comes from ``np.random.default_rng(seed)`` as in quimb_tpu, the
    arrays from the port's generator."""
    rng = np.random.default_rng(seed)
    fill_fn = get_rand_fill_fn(dist=dist, scale=scale, loc=loc,
                               seed=seed, dtype=dtype, device=device)

    terms = [[] for _ in range(n)]
    sizes = {}
    counter = itertools.count()

    def new_ind(tensors, name=None):
        ix = name if name is not None else f"__h{next(counter)}__"
        sizes[ix] = int(rng.integers(d_min, d_max + 1))
        for t in tensors:
            terms[t].append(ix)
        return ix

    # normal inner indices: ~ n*reg/2 random pairs
    n_inner = max((n * reg) // 2, n - 1)
    # first ensure connectivity with a random spanning tree
    order = rng.permutation(n)
    for i in range(1, n):
        a = order[i]
        b = order[rng.integers(0, i)]
        new_ind((int(a), int(b)))
    for _ in range(n_inner - (n - 1)):
        a, b = rng.choice(n, size=2, replace=False)
        new_ind((int(a), int(b)))
    # normal outer indices
    n_named = itertools.count()
    for _ in range(n_out):
        t = int(rng.integers(0, n))
        new_ind((t,), name=site_ind_id.format(next(n_named)))
    # hyper inner: on >= 3 tensors
    for _ in range(n_hyper_in):
        k = int(rng.integers(3, max(4, n // 2) + 1))
        ts = rng.choice(n, size=min(k, n), replace=False)
        new_ind(tuple(int(t) for t in ts))
    # hyper outer: in output and >= 2 tensors
    for _ in range(n_hyper_out):
        k = int(rng.integers(2, max(3, n // 2) + 1))
        ts = rng.choice(n, size=min(k, n), replace=False)
        new_ind(tuple(int(t) for t in ts),
                name=site_ind_id.format(next(n_named)))

    return TensorNetwork([
        Tensor(
            _on_device(fill_fn(tuple(sizes[ix] for ix in term)), device),
            inds=tuple(term),
        )
        for term in terms
    ])


def HTN_CP_from_inds_and_fill_fn(fill_fn, inds, sizes, D, tags=None,
                                 bond_ind=None, device=None):
    """CP-decomposition-structured HTN over given outer indices
    (reference ``HTN_CP_from_inds_and_fill_fn``
    tensor_builder.py:985)."""
    tn = TensorNetwork([])
    if tags is None:
        tags = [None] * len(inds)
    if bond_ind is None:
        bond_ind = rand_uuid()
    for ix, p, tag in zip(inds, sizes, tags):
        tn.add_tensor(
            Tensor(_on_device(fill_fn((D, p)), device),
                   inds=(bond_ind, ix), tags=tag),
            virtual=True,
        )
    return tn


def HTN_CP_from_sites_and_fill_fn(fill_fn, sites, D, phys_dim=2,
                                  site_tag_id="I{}", site_ind_id="k{}",
                                  bond_ind=None, device=None):
    """CP-structured HTN state over sites (reference
    ``HTN_CP_from_sites_and_fill_fn`` tensor_builder.py:1034)."""
    sites = tuple(sites)
    if bond_ind is None:
        bond_ind = rand_uuid()
    tn = TensorNetwork([
        Tensor(_on_device(fill_fn((D, phys_dim)), device),
               inds=(bond_ind, site_ind_id.format(site)),
               tags=(site_tag_id.format(site),))
        for site in sites
    ], virtual=True)
    return tn.view_as_(
        TensorNetworkGenVector, sites=sites, site_tag_id=site_tag_id,
        site_ind_id=site_ind_id,
    )


def HTN_CP_operator_from_products(array_seqs, upper_inds, lower_inds,
                                  tags_each=None, tags_all=None,
                                  bond_ind=None, device=None):
    """CP-form HTN of a sum of operator strings ``sum_i A_i B_i...``
    using one hyper index (reference ``HTN_CP_operator_from_products``
    tensor_builder.py:1086)."""
    upper_inds = tuple(
        (lix,) if isinstance(lix, str) else tuple(lix)
        for lix in upper_inds
    )
    lower_inds = tuple(
        (lix,) if isinstance(lix, str) else tuple(lix)
        for lix in lower_inds
    )
    if tags_each is None:
        tags_each = [None] * len(upper_inds)
    if bond_ind is None:
        bond_ind = rand_uuid()

    tns = []
    for arrays in array_seqs:
        tn = TensorNetwork([])
        for array, uix, lix, tgs in zip(arrays, upper_inds,
                                        lower_inds, tags_each):
            array = _on_device(array, device)
            tn.add_tensor(Tensor(
                array.reshape(1, *array.shape),
                inds=(bond_ind, *uix, *lix), tags=tgs,
            ), virtual=True)
        tns.append(tn)

    tn = functools.reduce(tensor_network_sum, tns)
    for tag in tags_to_oset(tags_all):
        tn.add_tag(tag)
    return tn


def HTN_dual_from_edges_and_fill_fn(fill_fn, edges, D, phys_dim=None,
                                    site_tag_id="I{}",
                                    site_ind_id="k{}", device=None):
    """Hyper TN with a tensor per *bond* and a hyper index per node
    (reference ``HTN_dual_from_edges_and_fill_fn``
    tensor_builder.py:1160)."""
    node_inds = collections.defaultdict(rand_uuid)
    ts = []
    for node_a, node_b in gen_unique_edges(edges):
        ts.append(Tensor(
            _on_device(fill_fn((D, D)), device),
            inds=(node_inds[node_a], node_inds[node_b]),
            tags=(site_tag_id.format(node_a),
                  site_tag_id.format(node_b)),
        ))
    sites = tuple(node_inds)
    if phys_dim is not None:
        for node, bnd in node_inds.items():
            ts.append(Tensor(
                _on_device(fill_fn((D, phys_dim)), device),
                inds=(bnd, site_ind_id.format(node)),
                tags=(site_tag_id.format(node),),
            ))
    tn = TensorNetwork(ts, virtual=True)
    if phys_dim is not None:
        return tn.view_as_(
            TensorNetworkGenVector, sites=sites,
            site_tag_id=site_tag_id, site_ind_id=site_ind_id,
        )
    return tn.view_as_(
        TensorNetworkGen, sites=sites, site_tag_id=site_tag_id
    )


def TN_matching(tn, max_bond, site_tags=None, fill_fn=None, dtype=None,
                device=None, **randn_opts):
    """TN with the same outer indices/site structure as ``tn`` but one
    random ``max_bond``-dim tensor per site, the standard initial guess
    for fitting (reference ``TN_matching`` tensor_builder.py:4063). The
    default fill draws on ``device``, else on the device of ``tn``'s
    tensors."""
    _, neighbors = create_lazy_edge_map(tn, site_tags)

    if device is None:
        device = next(iter(tn.tensor_map.values())).data.device
    if fill_fn is None:
        if dtype is None:
            try:
                dtype = tn.dtype
            except (AttributeError, ValueError):
                dtype = get_default_dtype()
        fill_fn = get_rand_fill_fn(dtype=dtype, device=device,
                                   **randn_opts)

    tn_match = TensorNetwork([])
    all_outer_ix = set(tn.outer_inds())
    bond_map = collections.defaultdict(rand_uuid)

    for site, other_sites in neighbors.items():
        tni = tn.select(site)
        loix = tuple(ix for ix in tni.outer_inds()
                     if ix in all_outer_ix)
        ltags = tags_to_oset(())
        for t in tni.tensor_map.values():
            ltags |= t.tags
        shape = []
        inds = []
        for other_site in other_sites:
            shape.append(max_bond)
            inds.append(bond_map[frozenset([site, other_site])])
        shape.extend(tn.ind_size(ix) for ix in loix)
        inds.extend(loix)
        tn_match.add_tensor(
            Tensor(_on_device(fill_fn(tuple(shape)), device), inds=inds,
                   tags=ltags),
            virtual=True,
        )
    return tn_match.view_like_(tn)


# ---------------------------------------------------------------------------
# 2D / 3D scalar lattices (reference tensor_builder.py:1230-2318)
# ---------------------------------------------------------------------------

def convert_to_2d(tn, Lx=None, Ly=None, site_tag_id="I{},{}",
                  x_tag_id="X{}", y_tag_id="Y{}", inplace=False):
    """Convert a generic-geometry TN with ``(i, j)`` sites into a
    :class:`TensorNetwork2D` (reference ``convert_to_2d``
    tensor_builder.py:1230)."""
    tn2d = tn if inplace else tn.copy()
    sites = tuple(tn2d.sites)
    if Lx is None:
        Lx = max(coo[0] for coo in sites) + 1
    if Ly is None:
        Ly = max(coo[1] for coo in sites) + 1
    for i, j in sites:
        old = tn2d.site_tag((i, j))
        new = site_tag_id.format(i, j)
        for tid in tuple(tn2d.tag_map.get(old, ())):
            t = tn2d.tensor_map[tid]
            t.retag_({old: new})
            t.add_tag((x_tag_id.format(i), y_tag_id.format(j)))
    return tn2d.view_as_(
        TensorNetwork2D, site_tag_id=site_tag_id, x_tag_id=x_tag_id,
        y_tag_id=y_tag_id, Lx=Lx, Ly=Ly,
    )


def convert_to_3d(tn, Lx=None, Ly=None, Lz=None,
                  site_tag_id="I{},{},{}", x_tag_id="X{}",
                  y_tag_id="Y{}", z_tag_id="Z{}", inplace=False):
    """Convert a generic-geometry TN with ``(i, j, k)`` sites into a
    :class:`TensorNetwork3D` (reference ``convert_to_3d``
    tensor_builder.py:1781)."""
    tn3d = tn if inplace else tn.copy()
    sites = tuple(tn3d.sites)
    if Lx is None:
        Lx = max(coo[0] for coo in sites) + 1
    if Ly is None:
        Ly = max(coo[1] for coo in sites) + 1
    if Lz is None:
        Lz = max(coo[2] for coo in sites) + 1
    for i, j, k in sites:
        old = tn3d.site_tag((i, j, k))
        new = site_tag_id.format(i, j, k)
        for tid in tuple(tn3d.tag_map.get(old, ())):
            t = tn3d.tensor_map[tid]
            t.retag_({old: new})
            t.add_tag((x_tag_id.format(i), y_tag_id.format(j),
                       z_tag_id.format(k)))
    return tn3d.view_as_(
        TensorNetwork3D, site_tag_id=site_tag_id, x_tag_id=x_tag_id,
        y_tag_id=y_tag_id, z_tag_id=z_tag_id, Lx=Lx, Ly=Ly, Lz=Lz,
    )


def _cyclic_per_axis(cyclic, n):
    try:
        out = tuple(cyclic)
    except TypeError:
        out = (cyclic,) * n
    return out


def TN2D_from_fill_fn(fill_fn, Lx, Ly, D, cyclic=False,
                      site_tag_id="I{},{}", x_tag_id="X{}",
                      y_tag_id="Y{}", device=None):
    """Scalar 2D lattice TN filled by ``fill_fn`` (reference
    ``TN2D_from_fill_fn`` tensor_builder.py:1294)."""
    cyclic_x, cyclic_y = _cyclic_per_axis(cyclic, 2)
    tn = TensorNetwork([])
    bond_map = LatticeBondMap(Lx, Ly)
    for i, j in itertools.product(range(Lx), range(Ly)):
        inds = []
        if j > 0 or cyclic_y:
            inds.append(bond_map((i, j), (i, j - 1)))
        if j < Ly - 1 or cyclic_y:
            inds.append(bond_map((i, j), (i, j + 1)))
        if i < Lx - 1 or cyclic_x:
            inds.append(bond_map((i, j), (i + 1, j)))
        if i > 0 or cyclic_x:
            inds.append(bond_map((i, j), (i - 1, j)))
        tn.add_tensor(Tensor(
            _on_device(fill_fn((D,) * len(inds)), device), inds=inds,
            tags=(site_tag_id.format(i, j), x_tag_id.format(i),
                  y_tag_id.format(j)),
        ), virtual=True)
    return tn.view_as_(
        TensorNetwork2D, site_tag_id=site_tag_id, x_tag_id=x_tag_id,
        y_tag_id=y_tag_id, Lx=Lx, Ly=Ly,
    )


def TN2D_empty(Lx, Ly, D, cyclic=False, site_tag_id="I{},{}",
               x_tag_id="X{}", y_tag_id="Y{}", dtype="float64",
               device=None):
    """Zero-filled scalar 2D lattice TN (reference ``TN2D_empty``
    tensor_builder.py:1375)."""
    return TN2D_from_fill_fn(
        lambda shape: np.zeros(shape, dtype=dtype), Lx, Ly, D,
        cyclic=cyclic, site_tag_id=site_tag_id, x_tag_id=x_tag_id,
        y_tag_id=y_tag_id, device=resolve_device(device))


def TN2D_with_value(value, Lx, Ly, D, cyclic=False,
                    site_tag_id="I{},{}", x_tag_id="X{}",
                    y_tag_id="Y{}", dtype=None, device=None):
    """Constant-filled scalar 2D lattice TN (reference
    ``TN2D_with_value`` tensor_builder.py:1427)."""
    return TN2D_from_fill_fn(
        _value_fill(value, dtype), Lx, Ly, D, cyclic=cyclic,
        site_tag_id=site_tag_id, x_tag_id=x_tag_id, y_tag_id=y_tag_id,
        device=resolve_device(device))


def TN2D_rand(Lx, Ly, D, cyclic=False, site_tag_id="I{},{}",
              x_tag_id="X{}", y_tag_id="Y{}", dist="normal", loc=0.0,
              scale=1.0, seed=None, dtype=None, device=None):
    """Random scalar 2D lattice TN (reference ``TN2D_rand``
    tensor_builder.py:1484)."""
    fill_fn = get_rand_fill_fn(dist, loc, scale, seed, dtype or "float64",
                               device=device)
    return TN2D_from_fill_fn(fill_fn, Lx, Ly, D, cyclic=cyclic,
                             site_tag_id=site_tag_id,
                             x_tag_id=x_tag_id, y_tag_id=y_tag_id,
                             device=device)


def TN2D_rand_symmetric(Lx, Ly, D, cyclic=False, site_tag_id="I{},{}",
                        x_tag_id="X{}", y_tag_id="Y{}", dist="normal",
                        loc=0.0, scale=1.0, seed=None, dtype="float64",
                        device=None):
    """Random 2D lattice TN with permutation-symmetric tensors
    (reference ``TN2D_rand_symmetric`` tensor_builder.py:1546). The
    scalars are drawn on the host, one stream for the whole lattice."""
    fill_fn = get_rand_fill_fn(dist, loc, scale, seed, dtype, device=_HOST)

    def symm_fill(shape):
        return rand_symmetric_array(D, len(shape), dtype=dtype,
                                    fill_fn=lambda _: fill_fn(()))

    return TN2D_from_fill_fn(symm_fill, Lx, Ly, D, cyclic=cyclic,
                             site_tag_id=site_tag_id, x_tag_id=x_tag_id,
                             y_tag_id=y_tag_id,
                             device=resolve_device(device))


def gen_2d_plaquettes(Lx, Ly, tiling=2):
    """Generate the plaquette loop strings of a 2D square lattice
    (reference ``gen_2d_plaquettes`` tn2d/core.py:161). ``tiling=1``
    gives a checkerboard (one line per edge), ``tiling=2`` every
    plaquette (two lines per edge)."""
    tiling = int(tiling)
    if tiling not in (1, 2):
        raise ValueError("tiling must be 1 or 2")
    for i, j in itertools.product(range(Lx - 1), range(Ly - 1)):
        if tiling == 2 or (i + j) % 2 == 0:
            yield ((i, j), (i + 1, j), (i + 1, j + 1), (i, j + 1),
                   (i, j))


def gen_3d_plaquettes(Lx, Ly, Lz, tiling=1):
    """Generate plaquette loop strings of a 3D cubic lattice in each
    axis plane (reference ``gen_3d_plaquettes`` tn3d/core.py:154)."""
    tiling = int(tiling)
    if tiling not in (1, 2):
        raise ValueError("tiling must be 1 or 2")
    for i, j, k in itertools.product(range(Lx), range(Ly), range(Lz)):
        # xy plaquettes
        if i < Lx - 1 and j < Ly - 1 and (tiling == 2 or k % 2 == 0):
            yield ((i, j, k), (i + 1, j, k), (i + 1, j + 1, k),
                   (i, j + 1, k), (i, j, k))
        # xz plaquettes
        if i < Lx - 1 and k < Lz - 1 and (tiling == 2 or j % 2 == 0):
            yield ((i, j, k), (i + 1, j, k), (i + 1, j, k + 1),
                   (i, j, k + 1), (i, j, k))
        # yz plaquettes
        if j < Ly - 1 and k < Lz - 1 and (tiling == 2 or i % 2 == 0):
            yield ((i, j, k), (i, j + 1, k), (i, j + 1, k + 1),
                   (i, j, k + 1), (i, j, k))


def _fill_missing_edges(strings, bond_gen, tiling):
    freqs = compute_string_edge_frequencies(strings)
    for edge in bond_gen:
        edge = tuple(sorted(edge))
        density = freqs.get(edge, 0)
        if density < tiling:
            strings.extend([edge] * (tiling - density))
    return strings


def TN2D_corner_double_line(Lx, Ly, line_dim=2, tiling=2,
                            fill_missing_edges=True,
                            site_tag_id="I{},{}", x_tag_id="X{}",
                            y_tag_id="Y{}", **kwargs):
    """2D corner-double-line (CDL) TN: strong local correlations,
    exactly contractible before site contraction; identity matrices
    give contracted value ``line_dim**num_plaquettes`` (reference
    ``TN2D_corner_double_line`` tensor_builder.py:1616, see
    arXiv:1412.0732)."""
    strings = list(gen_2d_plaquettes(Lx, Ly, tiling=tiling))
    if fill_missing_edges:
        _fill_missing_edges(strings, gen_2d_bonds(Lx, Ly), tiling)
    tn = TN_from_strings(strings, line_dim=line_dim, **kwargs)
    return convert_to_2d(tn, Lx, Ly, site_tag_id=site_tag_id,
                         x_tag_id=x_tag_id, y_tag_id=y_tag_id,
                         inplace=True)


def TN2D_rand_hidden_loop(Lx, Ly, *, cyclic=False, line_dim=2,
                          line_density=2, seed=None, dist="normal",
                          dtype="float64", loc=0.0, scale=1.0,
                          gauge_random=True, site_tag_id="I{},{}",
                          x_tag_id="X{}", y_tag_id="Y{}", device=None,
                          **kwargs):
    """Random 2D hidden-loop TN: random strings on lattice edges,
    randomly rewired/joined/gauged (reference
    ``TN2D_rand_hidden_loop`` tensor_builder.py:1696)."""
    fill_fn = get_rand_fill_fn(dist, loc, scale, seed, dtype, device=device)
    edges = tuple(gen_2d_bonds(Lx, Ly, cyclic=cyclic)) * line_density
    kwargs.setdefault("join", True)
    kwargs.setdefault("random_rewire", True)
    kwargs.setdefault("random_rewire_seed", seed)
    tn = TN_from_strings(edges, line_dim=line_dim, fill_fn=fill_fn,
                         device=device, **kwargs)
    if gauge_random:
        tn.gauge_all_random_(seed=seed)
    return convert_to_2d(tn, Lx, Ly, site_tag_id=site_tag_id,
                         x_tag_id=x_tag_id, y_tag_id=y_tag_id,
                         inplace=True)


def TN3D_from_fill_fn(fill_fn, Lx, Ly, Lz, D, cyclic=False,
                      site_tag_id="I{},{},{}", x_tag_id="X{}",
                      y_tag_id="Y{}", z_tag_id="Z{}", device=None):
    """Scalar 3D lattice TN filled by ``fill_fn`` (reference
    ``TN3D_from_fill_fn`` tensor_builder.py:1855)."""
    cyclic_x, cyclic_y, cyclic_z = _cyclic_per_axis(cyclic, 3)
    tn = TensorNetwork([])
    bond_map = LatticeBondMap(Lx, Ly, Lz)
    for i, j, k in itertools.product(range(Lx), range(Ly), range(Lz)):
        inds = []
        for inbounds, neighbor in [
            (i > 0 or cyclic_x, (i - 1, j, k)),
            (i < Lx - 1 or cyclic_x, (i + 1, j, k)),
            (j > 0 or cyclic_y, (i, j - 1, k)),
            (j < Ly - 1 or cyclic_y, (i, j + 1, k)),
            (k > 0 or cyclic_z, (i, j, k - 1)),
            (k < Lz - 1 or cyclic_z, (i, j, k + 1)),
        ]:
            if inbounds:
                inds.append(bond_map((i, j, k), neighbor))
        tn.add_tensor(Tensor(
            _on_device(fill_fn((D,) * len(inds)), device), inds=inds,
            tags=(site_tag_id.format(i, j, k), x_tag_id.format(i),
                  y_tag_id.format(j), z_tag_id.format(k)),
        ), virtual=True)
    return tn.view_as_(
        TensorNetwork3D, site_tag_id=site_tag_id, x_tag_id=x_tag_id,
        y_tag_id=y_tag_id, z_tag_id=z_tag_id, Lx=Lx, Ly=Ly, Lz=Lz,
    )


def TN3D_empty(Lx, Ly, Lz, D, cyclic=False, site_tag_id="I{},{},{}",
               x_tag_id="X{}", y_tag_id="Y{}", z_tag_id="Z{}",
               dtype="float64", device=None):
    """Zero-filled 3D lattice TN (reference ``TN3D_empty``
    tensor_builder.py:1950)."""
    return TN3D_from_fill_fn(
        lambda shape: np.zeros(shape, dtype=dtype), Lx, Ly, Lz, D,
        cyclic=cyclic, site_tag_id=site_tag_id, x_tag_id=x_tag_id,
        y_tag_id=y_tag_id, z_tag_id=z_tag_id,
        device=resolve_device(device))


def TN3D_with_value(value, Lx, Ly, Lz, D, cyclic=False,
                    site_tag_id="I{},{},{}", x_tag_id="X{}",
                    y_tag_id="Y{}", z_tag_id="Z{}", dtype=None,
                    device=None):
    """Constant-filled 3D lattice TN (reference ``TN3D_with_value``
    tensor_builder.py:2010)."""
    return TN3D_from_fill_fn(
        _value_fill(value, dtype), Lx, Ly, Lz, D, cyclic=cyclic,
        site_tag_id=site_tag_id, x_tag_id=x_tag_id, y_tag_id=y_tag_id,
        z_tag_id=z_tag_id, device=resolve_device(device))


def TN3D_rand(Lx, Ly, Lz, D, cyclic=False, site_tag_id="I{},{},{}",
              x_tag_id="X{}", y_tag_id="Y{}", z_tag_id="Z{}",
              dist="normal", loc=0.0, scale=1.0, seed=None,
              dtype=None, device=None):
    """Random scalar 3D lattice TN (reference ``TN3D_rand``
    tensor_builder.py:2075)."""
    fill_fn = get_rand_fill_fn(dist, loc, scale, seed, dtype or "float64",
                               device=device)
    return TN3D_from_fill_fn(fill_fn, Lx, Ly, Lz, D, cyclic=cyclic,
                             site_tag_id=site_tag_id,
                             x_tag_id=x_tag_id, y_tag_id=y_tag_id,
                             z_tag_id=z_tag_id, device=device)


def TN3D_corner_double_line(Lx, Ly, Lz, line_dim=2, tiling=2,
                            fill_missing_edges=True,
                            site_tag_id="I{},{},{}", x_tag_id="X{}",
                            y_tag_id="Y{}", z_tag_id="Z{}", **kwargs):
    """3D corner-double-line TN (reference ``TN3D_corner_double_line``
    tensor_builder.py:2145)."""
    strings = list(gen_3d_plaquettes(Lx, Ly, Lz, tiling=tiling))
    if fill_missing_edges:
        _fill_missing_edges(strings, gen_3d_bonds(Lx, Ly, Lz), tiling)
    tn = TN_from_strings(strings, line_dim=line_dim, **kwargs)
    return convert_to_3d(tn, Lx, Ly, Lz, site_tag_id=site_tag_id,
                         x_tag_id=x_tag_id, y_tag_id=y_tag_id,
                         z_tag_id=z_tag_id, inplace=True)


def TN3D_rand_hidden_loop(Lx, Ly, Lz, *, cyclic=False, line_dim=2,
                          line_density=2, seed=None, dist="normal",
                          dtype="float64", loc=0.0, scale=1.0,
                          gauge_random=True, site_tag_id="I{},{},{}",
                          x_tag_id="X{}", y_tag_id="Y{}",
                          z_tag_id="Z{}", device=None, **kwargs):
    """Random 3D hidden-loop TN (reference ``TN3D_rand_hidden_loop``
    tensor_builder.py:2222)."""
    fill_fn = get_rand_fill_fn(dist, loc, scale, seed, dtype, device=device)
    edges = tuple(gen_3d_bonds(Lx, Ly, Lz)) * line_density
    kwargs.setdefault("join", True)
    kwargs.setdefault("random_rewire", True)
    kwargs.setdefault("random_rewire_seed", seed)
    tn = TN_from_strings(edges, line_dim=line_dim, fill_fn=fill_fn,
                         device=device, **kwargs)
    if gauge_random:
        tn.gauge_all_random_(seed=seed)
    return convert_to_3d(tn, Lx, Ly, Lz, site_tag_id=site_tag_id,
                         x_tag_id=x_tag_id, y_tag_id=y_tag_id,
                         z_tag_id=z_tag_id, inplace=True)


# ---------------------------------------------------------------------------
# classical Ising partition functions (reference :2364-3425)
# ---------------------------------------------------------------------------

def classical_ising_sqrtS_matrix(beta, j=1.0, asymm=None):
    """Square-root factor of the Ising bond matrix, a host array; for
    negative ``j`` supply paired ``asymm='l'``/``'r'`` to stay real
    (reference ``classical_ising_sqrtS_matrix`` tensor_builder.py:2364)."""
    if (j < 0.0) and (asymm is not None):
        if asymm == "l":
            return _host_S(beta, j)
        elif asymm == "r":
            return np.eye(2)
        raise ValueError(f"invalid asymm {asymm!r}")
    cp = math.cosh(j * beta) ** 0.5
    sp = math.sinh(j * beta) ** 0.5
    return np.array([[cp + sp, cp - sp],
                     [cp - sp, cp + sp]]) / 2**0.5


def parse_j_coupling_to_function(j):
    """Turn a scalar / dict / callable coupling spec into a callable
    ``j(node_a, node_b)`` (reference ``parse_j_coupling_to_function``
    tensor_builder.py:2470)."""
    if callable(j):
        return j
    if isinstance(j, dict):
        def j_factory(node_a, node_b):
            try:
                return j[(node_a, node_b)]
            except KeyError:
                return j[(node_b, node_a)]
        return j_factory

    def j_factory(node_a, node_b):
        return j

    return j_factory


def classical_ising_T_matrix(beta, j=1.0, h=0.0, directions="lrud",
                             output=False, asymm=None):
    """The single effective site tensor of the classical Ising model, a
    host array: product of sqrt bond factors and the field vector,
    contracted over the central spin (reference
    ``classical_ising_T_matrix`` tensor_builder.py:2418)."""
    try:
        js = tuple(j)
    except TypeError:
        js = (j,) * len(directions)
    try:
        asymms = tuple(asymm) if asymm is not None else (None,) * len(
            directions
        )
    except TypeError:
        asymms = (asymm,) * len(directions)

    arrays = [
        classical_ising_sqrtS_matrix(beta=beta, j=jd, asymm=a)
        for jd, a in zip(js, asymms)
    ] + [_host_H(beta, float(h))]
    inputs = tuple(("i", x) for x in directions) + (("i",),)
    out = tuple(directions)
    if output:
        out = out + ("i",)
    return array_contract(arrays, inputs, out)


def HTN2D_classical_ising_partition_function(Lx, Ly, beta, h=0.0,
                                             j=1.0, cyclic=False,
                                             ind_id="s{},{}",
                                             site_tag_id="I{},{}",
                                             device=None):
    """Hyper-TN form of the 2D Ising partition function: each classical
    spin is one (hyper) index (reference
    ``HTN2D_classical_ising_partition_function``
    tensor_builder.py:2504)."""
    device = resolve_device(device)
    cyclic_x, cyclic_y = _cyclic_per_axis(cyclic, 2)
    j_factory = parse_j_coupling_to_function(j)
    tn = TensorNetwork([])
    for ni, nj in itertools.product(range(Lx), range(Ly)):
        for ok, node_b in (
            (ni < Lx - 1 or cyclic_x, ((ni + 1) % Lx, nj)),
            (nj < Ly - 1 or cyclic_y, (ni, (nj + 1) % Ly)),
        ):
            if not ok:
                continue
            node_a = (ni, nj)
            tn.add_tensor(Tensor(
                classical_ising_S_matrix(
                    beta, j=j_factory(node_a, node_b), device=device,
                ),
                inds=(ind_id.format(*node_a), ind_id.format(*node_b)),
                tags=(site_tag_id.format(*node_a),
                      site_tag_id.format(*node_b)),
            ), virtual=True)
        if h != 0.0:
            tn.add_tensor(Tensor(
                classical_ising_H_matrix(beta, h=float(h),
                                         device=device),
                inds=(ind_id.format(ni, nj),),
                tags=(site_tag_id.format(ni, nj),),
            ), virtual=True)
    return tn


def HTN3D_classical_ising_partition_function(Lx, Ly, Lz, beta, j=1.0,
                                             h=0.0, cyclic=False,
                                             ind_id="s{},{},{}",
                                             site_tag_id="I{},{},{}",
                                             device=None):
    """Hyper-TN form of the 3D Ising partition function (reference
    ``HTN3D_classical_ising_partition_function``
    tensor_builder.py:2590)."""
    device = resolve_device(device)
    cyclics = _cyclic_per_axis(cyclic, 3)
    j_factory = parse_j_coupling_to_function(j)
    tn = TensorNetwork([])
    dims = (Lx, Ly, Lz)
    for coo in itertools.product(range(Lx), range(Ly), range(Lz)):
        for axis in range(3):
            if coo[axis] < dims[axis] - 1 or cyclics[axis]:
                nxt = list(coo)
                nxt[axis] = (coo[axis] + 1) % dims[axis]
                node_a, node_b = coo, tuple(nxt)
                tn.add_tensor(Tensor(
                    classical_ising_S_matrix(
                        beta, j=j_factory(node_a, node_b), device=device,
                    ),
                    inds=(ind_id.format(*node_a),
                          ind_id.format(*node_b)),
                    tags=(site_tag_id.format(*node_a),
                          site_tag_id.format(*node_b)),
                ), virtual=True)
        if h != 0.0:
            tn.add_tensor(Tensor(
                classical_ising_H_matrix(beta, h=float(h),
                                         device=device),
                inds=(ind_id.format(*coo),),
                tags=(site_tag_id.format(*coo),),
            ), virtual=True)
    return tn


def _outputs_set(outputs):
    if outputs:
        if isinstance(outputs[0], int):
            outputs = (outputs,)
        return set(map(tuple, outputs))
    return set()


def TN2D_classical_ising_partition_function(
    Lx, Ly, beta, j=1.0, h=0.0, cyclic=False, site_tag_id="I{},{}",
    x_tag_id="X{}", y_tag_id="Y{}", outputs=(), ind_id="s{},{}",
    dtype="float64", device=None,
):
    """Direct (one tensor per spin) TN form of the 2D Ising partition
    function (reference ``TN2D_classical_ising_partition_function``
    tensor_builder.py:2688). ``outputs`` sites keep a dangling spin
    index, giving the unnormalized marginal over them."""
    device = resolve_device(device)
    cyclic_x, cyclic_y = _cyclic_per_axis(cyclic, 2)
    j_factory = parse_j_coupling_to_function(j)
    outputs = _outputs_set(outputs)

    tn = TensorNetwork([])
    bond_map = LatticeBondMap(Lx, Ly)
    for ni, nj in itertools.product(range(Lx), range(Ly)):
        site = (ni, nj)
        directions = ""
        inds = []
        js = ()
        asymms = ()
        for inbounds, neighbor, direction in [
            (nj > 0 or cyclic_y, (ni, nj - 1), "l"),
            (nj < Ly - 1 or cyclic_y, (ni, nj + 1), "r"),
            (ni < Lx - 1 or cyclic_x, (ni + 1, nj), "u"),
            (ni > 0 or cyclic_x, (ni - 1, nj), "d"),
        ]:
            if inbounds:
                bond, seen = bond_map(site, neighbor, return_seen=True)
                if direction in "ld":
                    j_pair = bond_map.wrap(neighbor, site)
                else:
                    j_pair = bond_map.wrap(site, neighbor)
                js += (j_factory(*j_pair),)
                directions += direction
                asymms += ("r" if seen else "l",)
                inds.append(bond)
        site_is_output = site in outputs
        if site_is_output:
            inds.append(ind_id.format(ni, nj))
        tn.add_tensor(Tensor(
            to_device(classical_ising_T_matrix(
                beta=beta, directions=directions, j=js, h=float(h),
                asymm=asymms, output=site_is_output,
            ), device=device, dtype=to_torch_dtype(dtype)),
            inds=inds,
            tags=(site_tag_id.format(ni, nj), x_tag_id.format(ni),
                  y_tag_id.format(nj)),
        ), virtual=True)
    return tn.view_as_(
        TensorNetwork2D, site_tag_id=site_tag_id, x_tag_id=x_tag_id,
        y_tag_id=y_tag_id, Lx=Lx, Ly=Ly,
    )


def TN3D_classical_ising_partition_function(
    Lx, Ly, Lz, beta, j=1.0, h=0.0, cyclic=False,
    site_tag_id="I{},{},{}", x_tag_id="X{}", y_tag_id="Y{}",
    z_tag_id="Z{}", outputs=(), ind_id="s{},{},{}", dtype="float64",
    device=None,
):
    """Direct TN form of the 3D Ising partition function (reference
    ``TN3D_classical_ising_partition_function``
    tensor_builder.py:2815), in ``dtype`` on ``device``."""
    device = resolve_device(device)
    cyclics = _cyclic_per_axis(cyclic, 3)
    j_factory = parse_j_coupling_to_function(j)
    outputs = _outputs_set(outputs)

    tn = TensorNetwork([])
    bond_map = LatticeBondMap(Lx, Ly, Lz)
    dims = (Lx, Ly, Lz)
    for coo in itertools.product(range(Lx), range(Ly), range(Lz)):
        directions = ""
        inds = []
        js = ()
        asymms = ()
        for axis, dname in ((0, "xX"), (1, "yY"), (2, "zZ")):
            for step, direction in ((-1, dname[0]), (+1, dname[1])):
                nxt = list(coo)
                nxt[axis] = coo[axis] + step
                inbounds = 0 <= nxt[axis] < dims[axis] or cyclics[axis]
                if not inbounds:
                    continue
                neighbor = tuple(nxt)
                bond, seen = bond_map(coo, neighbor, return_seen=True)
                if step < 0:
                    j_pair = bond_map.wrap(neighbor, coo)
                else:
                    j_pair = bond_map.wrap(coo, neighbor)
                js += (j_factory(*j_pair),)
                directions += direction
                asymms += ("r" if seen else "l",)
                inds.append(bond)
        site_is_output = coo in outputs
        if site_is_output:
            inds.append(ind_id.format(*coo))
        tn.add_tensor(Tensor(
            to_device(classical_ising_T_matrix(
                beta=beta, directions=directions, j=js, h=float(h),
                asymm=asymms, output=site_is_output,
            ), device=device, dtype=to_torch_dtype(dtype)),
            inds=inds,
            tags=(site_tag_id.format(*coo), x_tag_id.format(coo[0]),
                  y_tag_id.format(coo[1]), z_tag_id.format(coo[2])),
        ), virtual=True)
    return tn.view_as_(
        TensorNetwork3D, site_tag_id=site_tag_id, x_tag_id=x_tag_id,
        y_tag_id=y_tag_id, z_tag_id=z_tag_id, Lx=Lx, Ly=Ly, Lz=Lz,
    )


def make_couplings_matrix_symmetric(J, UPLO="auto"):
    """Coerce a possibly triangular coupling matrix into symmetric form
    (reference ``make_couplings_matrix_symmetric``
    tensor_builder.py:3127)."""
    J = np.asarray(J)
    if UPLO == "auto":
        lower = np.allclose(J, np.tril(J))
        upper = np.allclose(J, np.triu(J))
        if lower and not upper:
            UPLO = "L"
        elif upper and not lower:
            UPLO = "U"
        else:
            if not np.allclose(J, J.T):
                raise ValueError(
                    "coupling matrix is neither triangular nor "
                    "symmetric"
                )
            return J
    if UPLO == "L":
        return np.tril(J) + np.tril(J, -1).T
    if UPLO == "U":
        return np.triu(J) + np.triu(J, 1).T
    raise ValueError(f"invalid UPLO {UPLO!r}")


def TN2D_embedded_classical_ising_partition_function(
    Jij, beta, outputs=(), ordering=None, sites_location="side",
    UPLO="auto", contract_sites=True, site_tag_id="I{},{}",
    x_tag_id="X{}", y_tag_id="Y{}", ind_id="s{}", device=None,
):
    """All-to-all-coupled Ising partition function embedded in a
    triangular 2D lattice: each spin is delocalized into a COPY-MPS
    across a lattice diagonal, with the pair interaction matrix at
    site ``(i, j)`` for ``i > j`` (reference
    ``TN2D_embedded_classical_ising_partition_function``
    tensor_builder.py:3190)."""
    device = resolve_device(device)
    if isinstance(Jij, dict):
        N = max(max(pair) for pair in Jij) + 1
        Jm = np.zeros((N, N))
        for (a, b), v in Jij.items():
            Jm[a, b] = v
            Jm[b, a] = v
    else:
        Jm = make_couplings_matrix_symmetric(Jij, UPLO)
        N = Jm.shape[0]

    if ordering is not None:
        Jm = Jm[np.ix_(ordering, ordering)]

    outputs = set(outputs)
    tn = TensorNetwork([])

    # Each spin ``s`` is delocalized into a COPY line: its *row* line
    # runs through sites (s, 0..s-1) and its *column* line through
    # sites (s+1..N-1, s); the two are joined at the diagonal (the
    # segment between (s, s-1) and (s+1, s)), so every spin is one
    # connected line summed exactly once.
    copy_inds = collections.defaultdict(rand_uuid)

    def spin_ind(s, i, j):
        return copy_inds[(s, i, j)]

    def arr(x):
        return to_device(x, device=device)

    for i in range(1, N):
        for j in range(i):
            # spin j's (column) line segments at site (i, j)
            inds_j = [spin_ind(j, i, j)]
            if i < N - 1:
                inds_j.append(spin_ind(j, i + 1, j))
            # spin i's (row) line segments at site (i, j)
            inds_i = [spin_ind(i, i, j)]
            if j < i - 1:
                inds_i.append(spin_ind(i, i, j + 1))
            elif i < N - 1:
                # junction: glue row line of spin i (ends at
                # (i, i-1)) to its column line (starts at (i+1, i))
                inds_i.append(spin_ind(i, i + 1, i))

            di = delta_array((2,) * (len(inds_i) + 1))
            dj = delta_array((2,) * (len(inds_j) + 1))
            data = array_contract(
                [di, _host_S(beta, Jm[i, j]), dj],
                [tuple(inds_i) + ("a",), ("a", "b"),
                 tuple(inds_j) + ("b",)],
                tuple(inds_i) + tuple(inds_j),
            )
            tn.add_tensor(Tensor(
                arr(data), inds=tuple(inds_i) + tuple(inds_j),
                tags=(site_tag_id.format(i, j), x_tag_id.format(i),
                      y_tag_id.format(j)),
            ), virtual=True)

    # every spin now has exactly one dangling line end: (s, s, 0) for
    # s >= 1, and (0, 1, 0) for spin 0. Cap with ones (performs the
    # spin sum) or expose as output index.
    for s in range(N):
        key = (s, s, 0) if s >= 1 else (0, 1, 0)
        if key not in copy_inds:
            continue
        ix = copy_inds[key]
        if s in outputs:
            if sites_location == "diag" and (s, s + 1, s) in copy_inds:
                # expose at the diagonal junction instead: splice a
                # COPY into that segment
                jix = copy_inds[(s, s + 1, s)]
                mid = rand_uuid()
                t_with = [t for t in tn.tensor_map.values()
                          if jix in t.inds]
                t_with[0].reindex_({jix: mid})
                tn.add_tensor(Tensor(
                    arr(delta_array((2, 2, 2))),
                    inds=(mid, jix, ind_id.format(s)),
                ), virtual=True)
                # still need to cap the side end
                tn.add_tensor(
                    Tensor(arr(np.ones(2)), inds=(ix,)), virtual=True
                )
            else:
                tn.reindex_({ix: ind_id.format(s)})
        else:
            tn.add_tensor(
                Tensor(arr(np.ones(2)), inds=(ix,)), virtual=True
            )

    if contract_sites:
        # absorb the rank-1 caps into their neighbours
        tn.rank_simplify_(
            output_inds=[ind_id.format(s) for s in outputs]
        )
    return tn


# ---------------------------------------------------------------------------
# SAT / model counting (reference :3869-4062)
# ---------------------------------------------------------------------------

def HTN_from_cnf(fname, mode="parafac", dtype="float64",
                 clause_tag_id="CLAUSE{}", var_ind_id="var{}",
                 weight_tag_id="WEIGHT{}", device=None, **kwargs):
    """Hyper TN from a '.cnf'/'.wcnf' model counting instance file
    (reference ``HTN_from_cnf`` tensor_builder.py:3869)."""
    instance = cnf_file_parse(fname)
    return HTN_from_clauses(
        clauses=instance["clauses"],
        weights=instance.get("weights"),
        mode=mode, dtype=dtype, clause_tag_id=clause_tag_id,
        var_ind_id=var_ind_id, weight_tag_id=weight_tag_id,
        device=device, **kwargs,
    )


def random_ksat_instance(k, num_variables, num_clauses=None,
                         alpha=None, seed=None,
                         allow_repeat_variables=False):
    """Random k-SAT instance dict (reference ``random_ksat_instance``
    tensor_builder.py:3924), drawn from ``np.random.default_rng(seed)``
    as quimb_tpu draws it."""
    rng = np.random.default_rng(seed)
    all_vars = np.arange(1, num_variables + 1)
    if alpha is not None:
        if num_clauses is not None:
            raise ValueError(
                "can't specify both num_clauses and alpha"
            )
        num_clauses = int(rng.poisson(alpha * num_variables))
    elif num_clauses is None:
        raise ValueError("must specify either num_clauses or alpha")

    clauses = []
    for _ in range(num_clauses):
        vs = rng.choice(all_vars, size=k,
                        replace=allow_repeat_variables)
        sgns = rng.choice([-1, 1], size=k)
        clauses.append(tuple(int(s * v) for s, v in zip(sgns, vs)))
    return {
        "num_variables": num_variables,
        "num_clauses": num_clauses,
        "clauses": clauses,
        "k": k,
    }


def HTN_random_ksat(k, num_variables, num_clauses=None, alpha=None,
                    seed=None, allow_repeat_variables=False,
                    mode="parafac", dtype="float64",
                    clause_tag_id="CLAUSE{}", variable_ind_id="var{}",
                    device=None):
    """Random k-SAT instance as a hyper TN (reference
    ``HTN_random_ksat`` tensor_builder.py:3986)."""
    instance = random_ksat_instance(
        k, num_variables, num_clauses=num_clauses, alpha=alpha,
        seed=seed, allow_repeat_variables=allow_repeat_variables,
    )
    return HTN_from_clauses(
        instance["clauses"], mode=mode, dtype=dtype,
        clause_tag_id=clause_tag_id, var_ind_id=variable_ind_id,
        device=device,
    )
