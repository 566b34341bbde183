"""The multi-device layer on ``torch.distributed``: the port of
``quimb_tpu/parallel/mesh.py``.

quimb_tpu's mesh is single-controller: one process drives every device
and XLA inserts the collectives. Here each device has a process of its
own, a *rank*. Every rank calls the same function with the same arguments
and gets the same result, and the collectives are explicit: only
``all_gather``, ``all_reduce`` and ``broadcast``, which gloo (CPU tensors)
and NCCL (CUDA tensors) both implement. A
:class:`~torch.distributed.device_mesh.DeviceMesh` over the ranks carries
quimb_tpu's axis names (``"d"``; ``"dl"``, ``"dr"``).

- The world: :func:`distributed_init` joins a launcher's world
  (``torchrun --nproc-per-node=N``); with no world yet, :func:`get_mesh`
  and :func:`get_mesh_2d` start a one-rank world in the process, NCCL on
  the card or gloo for ``device="cpu"``.
- :func:`mesh_put` places a tensor as a DTensor: a dimension is sharded
  where its size divides its mesh axis, and replicated elsewhere.
- :class:`ShardedSparseHam` holds one contiguous row slab per rank. Its
  matvec computes the rank's rows from the full vector, and one all-gather
  gives every rank the full result, so the Krylov solvers
  (:func:`eigh_lanczos_sharded`, :func:`expm_multiply_sharded`) run
  unchanged on replicated vectors.
- :func:`approx_spectral_sharded`: each rank runs its share of the probes
  as one batch.
- :func:`contract_sliced` / :func:`contract_tn_mesh`: each rank builds and
  contracts its share of the slices as one batch; an all-reduce sums them.

The engines (``DMRG.shard_onto``, ``TEBD.shard_onto``) compute on the local
blocks (``.to_local()``) with these collectives, not through DTensor's
operator dispatch, which has no sharding rule for an SVD, a QR or a
hand-written kernel.
"""

import math
import os
import warnings
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

from ..ops.backend import numpy_dtype, resolve_device, to_device, to_torch_dtype
from ..ops.backend import to_host as _host

_REAL = {torch.complex128: torch.float64, torch.complex64: torch.float32}
#: the batch label of the slices in :func:`contract_sliced`
_SLICE = "__mesh_slice__"


# -- the world and the mesh ----------------------------------------------------


def _local_rank():
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()
                              % max(torch.cuda.device_count(), 1)))


def distributed_init(**kwargs):
    """Join a launcher's world: ``torch.distributed.init_process_group(
    **kwargs)``, by default NCCL over the ``env://`` rendezvous that
    ``torchrun`` sets up, each rank on the card of its local rank. Returns
    at once when a group exists already; any error of the rendezvous
    reaches the caller (the reference's ``quimb-mpi-python`` launcher
    becomes ``torchrun`` and this call)."""
    if dist.is_initialized():
        return
    kwargs.setdefault("backend", "nccl")
    dist.init_process_group(**kwargs)
    if "nccl" in str(kwargs["backend"]):
        torch.cuda.set_device(_local_rank())


def _world(device):
    """``device`` resolved (the card by default), with a world to run on:
    a one-rank world from an in-process store, NCCL on the card or gloo on
    the CPU, if there is none."""
    device = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    return device


def _init_mesh(shape, names, device, devices=None):
    """A DeviceMesh of ``shape`` (the world's size by default) over the
    world, on ``device``'s type; or over ``devices``, one device a rank in
    rank order, a list as long as the world."""
    from torch.distributed.device_mesh import init_device_mesh

    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if len({d.type for d in devices}) != 1:
            raise ValueError("a mesh's devices must be of one type")
        device = devices[0]
    device = _world(device)
    world = dist.get_world_size()
    if devices is not None:
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices given for a world of "
                             f"{world} ranks: one device a rank")
        device = devices[dist.get_rank()]
    if shape is None:
        shape = (world,)
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} asked for in a "
                         f"world of {world} ranks: start as many ranks as "
                         f"the mesh has (torchrun --nproc-per-node=N)")
    if device.type == "cuda":
        torch.cuda.set_device(_local_rank() if devices is None
                              else device)
    return init_device_mesh(device.type, tuple(shape),
                            mesh_dim_names=tuple(names))


def get_mesh(n=None, axis_name="d", devices=None, device=None):
    """A 1D mesh over every rank of the world, one device per rank: the
    card of the rank's local rank, or the CPU with ``device="cpu"``. With
    no world yet it starts a one-rank world. ``n``, if given, must be the
    world's size. ``devices``, quimb_tpu's keyword, lists the device of
    each rank (its first ``n`` with ``n``); its length must be the
    world's size."""
    if devices is not None and n is not None:
        devices = list(devices)[:n]
    world = None if n is None else (n,)
    return _init_mesh(world, (axis_name,), device, devices)


def get_mesh_2d(shape=None, axis_names=("dl", "dr"), devices=None,
                device=None):
    """A 2D mesh over the world for operator-style shardings (the two
    virtual axes of DMRG environments); by default the most square
    factorization of the world's size. ``devices`` lists the device of
    each rank, as in :func:`get_mesh`."""
    if shape is None:
        if devices is None:
            _world(device)
            n = dist.get_world_size()
        else:
            n = len(devices)
        p = int(math.sqrt(n))
        while n % p:
            p -= 1
        shape = (n // p, p)
    return _init_mesh(tuple(shape), axis_names, device, devices)


def mesh_device(mesh):
    """The device of this rank in ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_put(x, mesh, spec):
    """``x`` as a DTensor on ``mesh``: ``spec`` names a mesh axis (or
    ``None``) for each leading dimension of ``x``, as a ``PartitionSpec``
    does. A dimension whose size divides its axis is sharded over it
    (``Shard``); any other is replicated, so one spec serves a whole sweep
    whose edge tensors have size-1 bonds. Each rank keeps its block of its
    own copy of ``x`` (a view): nothing is communicated."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    placements = [Replicate()] * mesh.ndim
    block = x
    for dim, name in enumerate(tuple(spec)[: x.ndim]):
        if name is None:
            continue
        k = names.index(name)
        n = x.shape[dim] // mesh.size(k)
        if n * mesh.size(k) == x.shape[dim]:
            placements[k] = Shard(dim)
            block = block.narrow(dim, coord[k] * n, n)
    return DTensor.from_local(block, mesh, placements, run_check=False)


# -- collectives ----------------------------------------------------------------


def _all_gather(x, group=None):
    """Every rank's ``x`` (one shape on all), stacked in the group's rank
    order: one output buffer, with no per-rank copies."""
    world = dist.get_world_size(group)
    out = x.new_empty(world * x.numel())
    with warnings.catch_warnings():
        # torch 2.13 deprecates it for all_gather_single, which 2.11 lacks
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x.contiguous().reshape(-1),
                                    group=group)
    return out.view(world, *x.shape)


def _all_reduce(x, group=None):
    """``x`` summed over the group, in place. NCCL takes contiguous
    buffers only: another layout is reduced in a contiguous copy and
    copied back, so ``x`` keeps its strides (and the products that read
    it, their order of sums)."""
    if x.is_contiguous():
        dist.all_reduce(x, group=group)
        return x
    y = x.contiguous()
    dist.all_reduce(y, group=group)
    return x.copy_(y)


def _broadcast(x, group=None, src=0):
    """``x`` of the group's rank ``src``, in place on every rank."""
    if group is not None:
        src = dist.get_global_rank(group, src)
    dist.broadcast(x, src=src, group=group)
    return x


def broadcast_tensors(ts, group=None):
    """The group's first rank's tensors ``ts`` on every rank of the group,
    copied in place into each rank's own (which keep their strides):
    every rank passes tensors of the same shapes and dtype, which travel
    in one buffer. Returns ``ts``."""
    buf = _broadcast(torch.cat([t.reshape(-1) for t in ts]), group)
    for t, p in zip(ts, torch.split(buf, [t.numel() for t in ts])):
        t.copy_(p.view(t.shape))
    return ts


# -- the row-sharded operator -----------------------------------------------------


class ShardedSparseHam:
    """A sparse hermitian operator in contiguous row slabs, one per rank
    of a 1D mesh (the PETSc-Mat analogue, slepc_linalg.py:105).

    Each rank builds only its own slab, from the host matrix, in ELL
    format: every row padded to the largest nonzero count of any row, so
    the local matvec is a gather and a dense row sum. Where that padding
    would take more than 4x the nonzeros (one dense row among sparse
    ones), rows are cut into virtual rows of at most ``ceil(4 nnz /
    n_pad)`` entries whose partial sums ``index_add_`` folds back into
    their rows. ``n`` is padded to a multiple of the ranks with empty
    rows. :attr:`C` and :attr:`V` (and the chunked layout's row map
    ``_S``) are DTensors sharded over the mesh: ``(ranks, rows, width)``.
    """

    def __init__(self, H, mesh=None, dtype=None):
        import scipy.sparse as sp
        from torch.distributed.tensor import DTensor, Shard

        from ..config import get_default_dtype

        if mesh is None:
            mesh = get_mesh()
        self.mesh = mesh
        self.axis = mesh.mesh_dim_names[0]
        self._group = mesh.get_group(self.axis)
        self.device = mesh_device(mesh)
        nd = mesh.size(0)
        rank = mesh.get_local_rank(self.axis)

        Hc = H.tocoo() if sp.issparse(H) else sp.coo_matrix(_host(H))
        if dtype is None:
            dtype = get_default_dtype()
            if np.iscomplexobj(Hc.data) and np.allclose(Hc.data.imag, 0):
                Hc = Hc.copy()
                Hc.data = Hc.data.real
                dtype = _REAL.get(dtype, dtype)
        self.dtype = to_torch_dtype(dtype)
        n = Hc.shape[0]
        self.n = n
        self.n_pad = -(-n // nd) * nd
        self.rows_per = rows_per = self.n_pad // nd
        self.shape = (n, n)

        counts = np.bincount(Hc.row, minlength=self.n_pad)
        kmax = max(int(counts.max()) if Hc.nnz else 1, 1)
        nnz = max(int(Hc.nnz), 1)
        kcap = kmax
        if self.n_pad * kmax > 4 * nnz:
            kcap = max(-(-4 * nnz // self.n_pad), 1)
        self._kcap = kcap

        order = np.argsort(Hc.row, kind="stable")
        r = Hc.row[order].astype(np.int64)
        c = Hc.col[order].astype(np.int32)
        v = Hc.data[order]
        if np.iscomplexobj(v) and not self.dtype.is_complex:
            v = v.real
        starts = np.zeros(self.n_pad + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        # this rank's entries: rows [r0, r0 + rows_per)
        r0 = rank * rows_per
        lo, hi = starts[r0], starts[r0 + rows_per]
        r, c, v = r[lo:hi], c[lo:hi], v[lo:hi]
        pos = np.arange(lo, hi, dtype=np.int64) - starts[r]
        vdt = numpy_dtype(self.dtype)

        if kcap == kmax:
            cols = np.zeros((rows_per, kmax), np.int32)
            vals = np.zeros((rows_per, kmax), vdt)
            cols[r - r0, pos] = c
            vals[r - r0, pos] = v
            self._S = None
        else:
            # row i owns ceil(count_i / kcap) virtual rows of width kcap,
            # all in its own slab; every slab is padded to the largest
            # virtual-row count of any slab
            nchunks = np.maximum(-(-counts // kcap), 1)
            vstarts = np.zeros(self.n_pad + 1, np.int64)
            np.cumsum(nchunks, out=vstarts[1:])
            slab_edges = vstarts[::rows_per]
            vper = int(np.diff(slab_edges).max())
            vchunk = pos // kcap
            lvrow = vstarts[r] + vchunk - slab_edges[rank]
            cols = np.zeros((vper, kcap), np.int32)
            vals = np.zeros((vper, kcap), vdt)
            cols[lvrow, pos - vchunk * kcap] = c
            vals[lvrow, pos - vchunk * kcap] = v
            # the local row of each virtual row (padding folds into row 0
            # with zero values)
            seg = np.zeros(vper, np.int64)
            mine = np.repeat(np.arange(rows_per), nchunks[r0:r0 + rows_per])
            seg[:len(mine)] = mine
            self._S = DTensor.from_local(
                to_device(seg[None], self.device), mesh, [Shard(0)],
                run_check=False)
        self.C = DTensor.from_local(to_device(cols[None], self.device), mesh,
                                    [Shard(0)], run_check=False)
        self.V = DTensor.from_local(
            to_device(vals[None], self.device, self.dtype), mesh,
            [Shard(0)], run_check=False)

    def shard_vector(self, x):
        """A host vector or a tensor as the matvec takes it: flat,
        zero-padded to ``n_pad``, on this rank's device; real entries in
        the operator's dtype, complex ones in their own."""
        if isinstance(x, torch.Tensor):
            x = x.reshape(-1).to(self.device)
            if not x.is_complex():
                x = x.to(self.dtype)
        else:
            x = np.asarray(x).reshape(-1)
            x = to_device(x, self.device, None if np.iscomplexobj(x)
                          else self.dtype)
        if x.numel() < self.n_pad:
            x = torch.cat([x, x.new_zeros(self.n_pad - x.numel())])
        return x

    def matvec(self, x):
        """``H @ x`` for the full (replicated) padded vector ``x``: this
        rank's rows, then one all-gather of every rank's rows."""
        C, V = self.C.to_local()[0], self.V.to_local()[0]
        src = x.index_select(0, C.reshape(-1)).reshape(C.shape)
        part = torch.sum(V * src, dim=-1)
        if self._S is not None:
            part = part.new_zeros(self.rows_per).index_add_(
                0, self._S.to_local()[0], part)
        return _all_gather(part, self._group).reshape(-1)

    def __matmul__(self, x):
        if not isinstance(x, torch.Tensor) or x.shape[0] != self.n_pad:
            x = self.shard_vector(x)
        return self.matvec(x)

    def to_host(self, y):
        """The first ``n`` entries of a padded vector, as a host array."""
        return _host(y)[: self.n]


def eigh_lanczos_sharded(H, v0=None, ncv=20, restarts=10, mesh=None,
                         seed=0):
    """Ground eigenpair of a host scipy (or dense) hermitian operator by
    the port's restarted Lanczos over the row-sharded matvec (the
    Krylov-Schur-over-MPI replacement, ``eigs_slepc``
    slepc_linalg.py:499). The start vector is
    ``default_rng(seed).standard_normal``, as in quimb_tpu. Returns (the
    eigenvalue, a 0-d tensor; the eigenvector on the host)."""
    from ..linalg.lanczos import eigh_lanczos

    Hs = H if isinstance(H, ShardedSparseHam) else \
        ShardedSparseHam(H, mesh=mesh)
    if v0 is None:
        v0 = np.random.default_rng(seed).standard_normal(Hs.n_pad)
        v0[Hs.n:] = 0.0
    lam, v = eigh_lanczos(Hs.matvec, Hs.shard_vector(v0), ncv=ncv,
                          restarts=restarts)
    return lam, Hs.to_host(v)


def expm_multiply_sharded(H, v, t=1.0, ncv=30, mesh=None, hermitian=True):
    """``exp(t H) v`` by the port's Krylov expm over the row-sharded matvec
    (the SLEPc MFN replacement, ``mfn_multiply_slepc``
    slepc_linalg.py:773); the result on the host."""
    from ..linalg.lanczos import expm_multiply_krylov

    Hs = H if isinstance(H, ShardedSparseHam) else \
        ShardedSparseHam(H, mesh=mesh)
    out = expm_multiply_krylov(Hs.matvec, Hs.shard_vector(v), t=t, ncv=ncv,
                               hermitian=hermitian)
    return Hs.to_host(out)


# -- stochastic Lanczos quadrature over the probes -------------------------------


def approx_spectral_sharded(A, f, R=128, K=40, mesh=None, seed=None,
                            pos=False):
    """``tr f(A)`` by stochastic Lanczos quadrature with the probes split
    over the ranks (the MPI-SLQ replacement, approx_spectral.py:696): the
    ``R`` Rademacher probes (``R`` padded to a multiple of the ranks) are
    drawn from ``default_rng(seed)`` as quimb_tpu draws them, each rank
    runs its share through ``construct_lanczos_tridiag`` as one batch, and
    the per-probe estimates are gathered. Returns (mean, its standard
    error), the same on every rank. ``A`` is an operator with ``matvec``
    or ``matmat`` (applied to its own device's tensors), or a dense
    matrix, moved to this rank's device."""
    from ..linalg.approx_spectral import (
        _operator_matmat,
        _quadrature_weights,
        construct_lanczos_tridiag,
    )

    if mesh is None:
        mesh = get_mesh()
    axis = mesh.mesh_dim_names[0]
    group = mesh.get_group(axis)
    nd, rank = mesh.size(0), mesh.get_local_rank(axis)
    R = -(-R // nd) * nd

    if hasattr(A, "matvec") or hasattr(A, "matmat"):
        mv, n, dtype, device = _operator_matmat(A)
    else:
        device = mesh_device(mesh)
        Aa = to_device(A, device)
        mv, n, dtype = (lambda X: Aa @ X), Aa.shape[0], Aa.dtype
    rng = np.random.default_rng(seed)
    real = numpy_dtype(_REAL.get(dtype, dtype))
    V0 = rng.choice([-1.0, 1.0], size=(R, n)).astype(
        numpy_dtype(dtype) if not dtype.is_complex else np.float64)
    per = R // nd
    V0 = to_device(V0[rank * per:(rank + 1) * per], device, dtype)
    K = int(min(K, n))
    alpha, beta = construct_lanczos_tridiag(mv, n, K, V0, dtype)
    w, tau2 = _quadrature_weights(alpha, beta)
    w = _host(w)
    if pos:
        w = np.clip(w, 0, None)
    vals = f(w)
    vals = np.where(np.isfinite(vals), vals, 0.0)
    ests = n * np.sum(_host(tau2) * vals, axis=1)
    ests = _host(_all_gather(to_device(ests.astype(real), device),
                             group).reshape(-1))
    return float(np.mean(ests)), float(np.std(ests) / math.sqrt(len(ests)))


# -- sliced contraction -------------------------------------------------------------


def _slice_stack(t, sliced_inds, digits, count, device):
    """The slices of tensor ``t`` at this rank's slice ids: its sliced axes
    indexed by ``digits`` (one index array per entry of ``sliced_inds``),
    stacked on a leading axis and zero-padded to ``count``. Returns (its
    index labels, the stack)."""
    data = t.data
    if isinstance(data, torch.Tensor):
        if data.device != device:
            raise ValueError(f"a tensor lies on {data.device}, the mesh's "
                             f"rank on {device}")
    else:
        data = to_device(data, device)
    axes = [k for k, ix in enumerate(t.inds) if ix in sliced_inds]
    if not axes:
        return tuple(t.inds), data
    rest = [k for k in range(data.ndim) if k not in axes]
    sel = tuple(torch.as_tensor(digits[sliced_inds.index(t.inds[k])],
                                device=device) for k in axes)
    stack = data.permute(axes + rest)[sel]
    if stack.shape[0] < count:
        stack = torch.cat([stack, stack.new_zeros(
            (count - stack.shape[0], *stack.shape[1:]))])
    return (_SLICE, *(t.inds[k] for k in rest)), stack


def contract_sliced(tn, sliced_inds, mesh=None, output_inds=(),
                    optimize=None):
    """Contract ``tn`` as the sum over the values of ``sliced_inds`` (the
    multi-device circuit path; reference ``cut_iter`` tensor_core.py:9088
    with cotengra's sliced indices). The slices are split over the ranks
    of the mesh's first axis, zero-padded to a multiple of the ranks; each
    rank builds only its own slices and contracts them as one batch, one
    expression carrying a slice label through every pairwise step; an
    all-reduce sums the ranks' parts. With no ``sliced_inds`` the network
    is contracted plainly. Returns the raw array."""
    from ..ops.contraction import array_contract_expression

    if mesh is None:
        mesh = get_mesh()
    sliced_inds = tuple(sliced_inds)
    output_inds = tuple(output_inds)
    if not sliced_inds:
        out = tn.contract(..., output_inds=output_inds, optimize=optimize)
        return out.data if hasattr(out, "data") else out
    axis = mesh.mesh_dim_names[0]
    group = mesh.get_group(axis)
    nd, rank = mesh.size(0), mesh.get_local_rank(axis)
    device = mesh_device(mesh)

    dims = [tn.ind_size(ix) for ix in sliced_inds]
    nslices = math.prod(dims)
    per = -(-nslices // nd)
    ids = np.arange(rank * per, min((rank + 1) * per, nslices))
    digits = np.unravel_index(ids, dims)
    inputs, arrays = [], []
    for t in tn.tensor_map.values():
        term, a = _slice_stack(t, sliced_inds, digits, per, device)
        inputs.append(term)
        arrays.append(a)
    expr = array_contract_expression(
        inputs, (_SLICE, *output_inds), shapes=[a.shape for a in arrays],
        optimize=optimize)
    total = _all_reduce(torch.sum(expr(*arrays), dim=0), group)
    if getattr(tn, "exponent", 0.0):
        total = total * 10 ** tn.exponent
    return total


def choose_sliced_inds(tn, target_slices, exclude=()):
    """Indices of ``tn`` to slice so that the number of slices (the
    product of their sizes) reaches at least ``target_slices``: greedily
    the inner indices first, larger sizes first (quimb_tpu's rule, in
    place of cotengra's slicing optimizer)."""
    cnt = Counter()
    for t in tn.tensor_map.values():
        for ix in t.inds:
            cnt[ix] += 1
    cands = sorted(
        (ix for ix in cnt if ix not in exclude and tn.ind_size(ix) > 1),
        key=lambda ix: (-min(cnt[ix], 2), -tn.ind_size(ix)),
    )
    chosen, nsl = [], 1
    for ix in cands:
        if nsl >= target_slices:
            break
        chosen.append(ix)
        nsl *= tn.ind_size(ix)
    return tuple(chosen)


def contract_tn_mesh(tn, mesh=None, output_inds=(), optimize=None,
                     sliced_inds=None):
    """Contract any network over the mesh: slice indices chosen for one
    slice per rank at least (unless given), then :func:`contract_sliced`.
    The slices partition the sum exactly."""
    if mesh is None:
        mesh = get_mesh()
    if sliced_inds is None:
        sliced_inds = choose_sliced_inds(tn, mesh.size(),
                                         exclude=set(output_inds))
    return contract_sliced(tn, sliced_inds, mesh=mesh,
                           output_inds=output_inds, optimize=optimize)


__all__ = [
    "ShardedSparseHam",
    "approx_spectral_sharded",
    "choose_sliced_inds",
    "contract_sliced",
    "contract_tn_mesh",
    "distributed_init",
    "eigh_lanczos_sharded",
    "expm_multiply_sharded",
    "get_mesh",
    "get_mesh_2d",
    "mesh_put",
]
