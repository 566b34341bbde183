"""Arbitrary-geometry TN builders (the general slice of reference
``tensor_builder.py``: ``TN_from_edges_*``, classical partition
functions, random regular graphs, boolean clauses, dimer coverings).

Port of quimb_tpu's ``tensor/tnag/builders.py``. Every builder takes
``device`` and puts its tensors on the GPU unless given another; an
array that a fill function returns as a tensor keeps its device when
``device`` is not given. Bond names come from ``rand_uuid``.
``TN_from_edges_rand`` draws from :func:`quimb_torch.gen.rand.randn`, a
torch generator, whose stream differs from quimb_tpu's JAX generator:
build from a numpy fill function to share arrays with quimb_tpu.
"""

import itertools

import numpy as np
import torch

from ...config import get_default_dtype
from ...gen.rand import randn
from ...ops.backend import resolve_device, to_device, to_torch_dtype
from ...utils import oset
from ..core import COPY_tensor, Tensor, TensorNetwork, rand_uuid
from .core import TensorNetworkGen, TensorNetworkGenVector


def _on_device(data, device):
    """``data`` as a tensor: on ``device`` when it is given, else a tensor
    keeps its own device and anything else goes to the GPU."""
    if device is None and isinstance(data, torch.Tensor):
        return data
    return to_device(data, device=resolve_device(device))


def TN_from_edges_and_fill_fn(
    fill_fn, edges, D, phys_dim=None, site_tag_id="I{}",
    site_ind_id="k{}", device=None,
):
    """Build a TN from a list of edges, one tensor per site with bond
    dimension ``D``. A tuple ``site_ind_id=(upper, lower)`` builds an
    operator network (two physical indices per site) — reference
    ``TN_from_edges_and_fill_fn`` tensor_builder.py:392 returns
    ``TensorNetworkGenOperator`` in that case."""
    sites = tuple(sorted(set(itertools.chain.from_iterable(edges))))
    bond_names = {
        tuple(sorted(e, key=str)): rand_uuid() for e in map(tuple, edges)
    }
    as_operator = isinstance(site_ind_id, (tuple, list))
    ts = {}
    for site in sites:
        inds = []
        shape = []
        for e, name in bond_names.items():
            if site in e:
                inds.append(name)
                shape.append(D)
        if phys_dim is not None:
            if as_operator:
                for ind_id in site_ind_id:
                    inds.append(ind_id.format(site))
                    shape.append(phys_dim)
            else:
                inds.append(site_ind_id.format(site))
                shape.append(phys_dim)
        data = _on_device(fill_fn(tuple(shape)), device)
        ts[site] = Tensor(data, inds=inds,
                          tags=oset((site_tag_id.format(site),)))
    tn = TensorNetwork(
        [ts[s] for s in sites], virtual=True, check_collisions=False
    )
    if phys_dim is not None and as_operator:
        from .core import TensorNetworkGenOperator

        upper_ind_id, lower_ind_id = site_ind_id
        tn.view_as_(
            TensorNetworkGenOperator, sites=sites,
            site_tag_id=site_tag_id, upper_ind_id=upper_ind_id,
            lower_ind_id=lower_ind_id,
        )
    elif phys_dim is not None:
        tn.view_as_(
            TensorNetworkGenVector, sites=sites,
            site_tag_id=site_tag_id, site_ind_id=site_ind_id,
        )
    else:
        tn.view_as_(
            TensorNetworkGen, sites=sites, site_tag_id=site_tag_id
        )
    return tn


def TN_from_edges_rand(edges, D, phys_dim=None, seed=None, dtype=None,
                       site_tag_id="I{}", site_ind_id="k{}",
                       normalize=False, device=None):
    """Random TN on a graph (reference ``TN_from_edges_rand``), drawn
    site by site from a generator seeded ``seed``, ``seed + 1``, ..."""
    dtype = dtype or get_default_dtype()
    device = resolve_device(device)
    counter = itertools.count()

    def fill_fn(shape):
        return randn(shape, dtype=dtype, device=device,
                     seed=None if seed is None else seed + next(counter))

    tn = TN_from_edges_and_fill_fn(
        fill_fn, edges, D, phys_dim=phys_dim, site_tag_id=site_tag_id,
        site_ind_id=site_ind_id, device=device,
    )
    if normalize and phys_dim is not None:
        nrm = float(torch.linalg.norm(tn.to_dense()))
        tn.multiply_(nrm**-1.0)
    return tn


TN_rand_from_edges = TN_from_edges_rand


def TN_from_edges_empty(edges, D, phys_dim=None, dtype=None,
                        site_tag_id="I{}", site_ind_id="k{}", device=None):
    dtype = to_torch_dtype(dtype or get_default_dtype())
    device = resolve_device(device)

    def fill_fn(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return TN_from_edges_and_fill_fn(
        fill_fn, edges, D, phys_dim=phys_dim, site_tag_id=site_tag_id,
        site_ind_id=site_ind_id, device=device,
    )


def TN_rand_reg(n, reg, D, phys_dim=None, seed=None, dtype=None,
                **kwargs):
    """Random TN on a random regular graph (reference
    ``TN_rand_reg``)."""
    from ..geometry import edges_rand_reg

    edges = edges_rand_reg(n, reg, seed=seed)
    return TN_from_edges_rand(edges, D, phys_dim=phys_dim, seed=seed,
                              dtype=dtype, **kwargs)


def classical_ising_S_matrix(beta, j=1.0, dtype="float64", device=None):
    """The local bond matrix exp(beta j s_a s_b)."""
    S = np.array([
        [np.exp(beta * j), np.exp(-beta * j)],
        [np.exp(-beta * j), np.exp(beta * j)],
    ])
    return to_device(S, device=resolve_device(device),
                     dtype=to_torch_dtype(dtype))


def classical_ising_H_matrix(beta, h=0.0, dtype="float64", device=None):
    return to_device(np.array([np.exp(beta * h), np.exp(-beta * h)]),
                     device=resolve_device(device),
                     dtype=to_torch_dtype(dtype))


def TN_classical_partition_function_from_edges(
    edges, beta, j=1.0, h=0.0, site_tag_id="I{}", dtype="float64",
    device=None,
):
    """The classical Ising partition function as a TN with one COPY
    tensor per site and one bond matrix per edge (reference
    ``TN_classical_partition_function_from_edges``)."""
    device = resolve_device(device)
    sites = tuple(sorted(set(itertools.chain.from_iterable(edges))))
    site_legs = {s: [] for s in sites}
    ts = []
    for e in map(tuple, edges):
        a, b = sorted(e, key=str)
        ia, ib = rand_uuid(), rand_uuid()
        site_legs[a].append(ia)
        site_legs[b].append(ib)
        je = j(a, b) if callable(j) else j
        ts.append(Tensor(
            classical_ising_S_matrix(beta, je, dtype, device),
            inds=(ia, ib),
        ))
    for s in sites:
        legs = site_legs[s]
        data = COPY_tensor(2, tuple(legs), dtype=to_torch_dtype(dtype),
                           device=device).data
        if h:
            hs = h(s) if callable(h) else h
            data = data * classical_ising_H_matrix(
                beta, hs, dtype, device,
            ).reshape((2,) + (1,) * (len(legs) - 1)) \
                if len(legs) else data
        ts.append(Tensor(data, inds=tuple(legs),
                         tags=oset((site_tag_id.format(s),))))
    tn = TensorNetwork(ts, virtual=True, check_collisions=False)
    tn.view_as_(TensorNetworkGen, sites=sites, site_tag_id=site_tag_id)
    return tn


def HTN_classical_partition_function_from_edges(
    edges, beta, j=1.0, h=0.0, site_ind_id="s{}", dtype="float64",
    device=None,
):
    """Hyper-TN form: one 2x2 bond tensor per edge sharing hyper site
    indices (reference HTN variant)."""
    device = resolve_device(device)
    ts = []
    sites = tuple(sorted(set(itertools.chain.from_iterable(edges))))
    for e in map(tuple, edges):
        a, b = sorted(e, key=str)
        je = j(a, b) if callable(j) else j
        ts.append(Tensor(
            classical_ising_S_matrix(beta, je, dtype, device),
            inds=(site_ind_id.format(a), site_ind_id.format(b)),
        ))
    if h:
        for s in sites:
            hs = h(s) if callable(h) else h
            ts.append(Tensor(
                classical_ising_H_matrix(beta, hs, dtype, device),
                inds=(site_ind_id.format(s),),
            ))
    return TensorNetwork(ts, virtual=True, check_collisions=False)


def HTN_from_clauses(clauses, weights=None, mode="dense",
                     site_ind_id="s{}", dtype="float64",
                     var_ind_id=None, clause_tag_id="CLAUSE{}",
                     weight_tag_id="WEIGHT{}", device=None):
    """Hyper tensor network whose full contraction counts (or weights)
    the satisfying assignments of boolean ``clauses`` (reference
    ``HTN_from_clauses`` / k-SAT builders tensor_builder.py).

    Parameters
    ----------
    clauses : sequence[sequence[int]]
        Each clause is a tuple of non-zero ints: variable ``v`` means
        the literal is satisfied when ``s_v = 1``; ``-v`` when
        ``s_v = 0`` (DIMACS convention, variables 1-based).
    weights : dict[int, float], optional
        Optional per-variable weight for the ``1`` state (else
        unweighted counting).

    Returns
    -------
    TensorNetwork
        Contracting with no output indices gives the (weighted) count
        of satisfying assignments.
    """
    if var_ind_id is not None:
        site_ind_id = var_ind_id
    device = resolve_device(device)

    def arr(x):
        return to_device(x, device=device)

    ts = []
    for c, clause in enumerate(clauses):
        vs = tuple(abs(v) for v in clause)
        inds = tuple(site_ind_id.format(v) for v in vs)
        tags = (clause_tag_id.format(c),)
        # the single violating assignment: every literal false
        viol = tuple(0 if v > 0 else 1 for v in clause)
        if isinstance(mode, int):
            cmode = "parafac" if len(vs) > mode else "dense"
        else:
            cmode = mode
        if cmode == "dense" or len(vs) == 1:
            data = np.ones((2,) * len(vs), dtype=dtype)
            data[viol] = 0.0
            ts.append(Tensor(arr(data), inds=inds, tags=tags))
        elif cmode == "parafac":
            # OR tensor = ones - e_viol1 x e_viol2 x ... : a rank-2
            # CP decomposition over one hyper index (reference
            # ``or_clause_parafac_data`` tensor_builder.py:3604)
            hyper = rand_uuid()
            for ix, vi in zip(inds, viol):
                f = np.zeros((2, 2), dtype=dtype)
                f[0, :] = 1.0
                f[1, vi] = 1.0
                ts.append(Tensor(arr(f), inds=(hyper, ix),
                                 tags=tags))
            ts.append(Tensor(
                arr(np.array([1.0, -1.0], dtype=dtype)),
                inds=(hyper,), tags=tags,
            ))
        elif cmode == "mps":
            # bond-2 MPS: bond carries (ones-part, all-violating
            # flag); final site subtracts the flag (reference
            # ``or_clause_mps_tensors`` tensor_builder.py:3571)
            bnds = [rand_uuid() for _ in range(len(vs) - 1)]
            for pos, (ix, vi) in enumerate(zip(inds, viol)):
                ind_v = np.zeros(2, dtype=dtype)
                ind_v[vi] = 1.0
                ones = np.ones(2, dtype=dtype)
                if pos == 0:
                    a = np.stack([ones, ind_v], axis=1)  # (s, b)
                    t_inds = (ix, bnds[0])
                elif pos < len(vs) - 1:
                    a = np.zeros((2, 2, 2), dtype=dtype)
                    a[0, :, 0] = ones
                    a[1, :, 1] = ind_v
                    t_inds = (bnds[pos - 1], ix, bnds[pos])
                else:
                    a = np.stack([ones, -ind_v], axis=0)  # (b, s)
                    t_inds = (bnds[pos - 1], ix)
                ts.append(Tensor(arr(a), inds=t_inds,
                                 tags=tags))
        else:
            raise ValueError(f"unknown clause mode {mode!r}")
    if weights:
        for v, w in weights.items():
            if isinstance(w, (tuple, list)):
                w0, w1 = w
            else:
                w0, w1 = 1.0, w
            ts.append(Tensor(
                arr(np.array([w0, w1], dtype=dtype)),
                inds=(site_ind_id.format(abs(v)),),
                tags=(weight_tag_id.format(abs(v)),),
            ))
    return TensorNetwork(ts, virtual=True, check_collisions=False)


def cnf_file_parse(fname_or_str):
    """Parse a DIMACS '.cnf'/'.wcnf' file (or its contents) into an
    instance dict with keys ``clauses``, ``weights``,
    ``num_variables``, ``num_clauses`` (reference ``cnf_file_parse``
    tensor_builder.py:3786)."""
    if "\n" in fname_or_str or " 0" in fname_or_str:
        contents = fname_or_str
    else:
        with open(fname_or_str) as f:
            contents = f.read()
    clauses = []
    weights = {}
    num_variables = 0
    for line in contents.splitlines():
        line = line.strip()
        if not line or line.startswith(("c", "p", "%")):
            if line.startswith("p"):
                parts = line.split()
                if len(parts) >= 3 and parts[2].isdigit():
                    num_variables = int(parts[2])
            continue
        if line.startswith("w"):
            # weighted literal: 'w <lit> <weight> [0]'
            parts = line.split()
            lit = int(parts[1])
            w = float(parts[2])
            if lit > 0:
                weights.setdefault(lit, [1.0, 1.0])[1] = w
            else:
                weights.setdefault(-lit, [1.0, 1.0])[0] = w
            continue
        vals = [int(x) for x in line.split()]
        if vals and vals[-1] == 0:
            vals = vals[:-1]
        if vals:
            clauses.append(tuple(vals))
            num_variables = max(
                num_variables, max(abs(v) for v in vals)
            )
    weights = {v: tuple(w) for v, w in weights.items()}
    return {
        "num_variables": num_variables,
        "num_clauses": len(clauses),
        "clauses": clauses,
        "weights": weights,
    }


def TN_dimer_covering_from_edges(edges, cover_count=1,
                                 site_ind_id=None, dtype="float64",
                                 device=None):
    """TN whose contraction counts the ``cover_count``-regular dimer
    coverings (perfect matchings for 1) of the graph: one 0/1 index
    per edge, one constraint tensor per site enforcing that exactly
    ``cover_count`` incident edges are occupied (reference
    ``TN_dimer_covering_from_edges`` tensor_builder.py)."""
    device = resolve_device(device)
    incident = {}
    edge_ix = {}
    for e in map(tuple, edges):
        a, b = sorted(e, key=str)
        ix = f"d_{a}_{b}" if site_ind_id is None else rand_uuid()
        edge_ix[a, b] = ix
        incident.setdefault(a, []).append(ix)
        incident.setdefault(b, []).append(ix)
    ts = []
    for site, ixs in incident.items():
        k = len(ixs)
        data = np.zeros((2,) * k, dtype=dtype)
        for occ in itertools.product((0, 1), repeat=k):
            if sum(occ) == cover_count:
                data[occ] = 1.0
        ts.append(Tensor(to_device(data, device=device), inds=tuple(ixs)))
    return TensorNetwork(ts, virtual=True, check_collisions=False)


def TN3D_classical_ising_partition_function(
    Lx, Ly, Lz, beta, j=1.0, h=0.0, cyclic=False, dtype="float64",
    device=None,
):
    """3D cubic-lattice classical Ising partition function TN
    (reference ``TN3D_classical_ising_partition_function``)."""
    edges = []
    for i, jj, k in itertools.product(range(Lx), range(Ly), range(Lz)):
        for d, (ni, nj, nk) in enumerate(
            ((i + 1, jj, k), (i, jj + 1, k), (i, jj, k + 1))
        ):
            dims = (Lx, Ly, Lz)
            nxt = (ni, nj, nk)
            if nxt[d] < dims[d]:
                edges.append(((i, jj, k), nxt))
            elif cyclic:
                w = list(nxt)
                w[d] = 0
                edges.append(((i, jj, k), tuple(w)))
    return HTN_classical_partition_function_from_edges(
        edges, beta=beta, j=j, h=h, dtype=dtype, device=device,
    )
