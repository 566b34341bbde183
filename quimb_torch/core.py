"""The exact layer: quantum objects, Kronecker products, partial traces and
Hamiltonians as sums of local terms, with the device operators that apply
them.

Port of ``quimb_tpu/core.py``: ``quimbify`` / ``qu`` / ``ket`` / ``bra`` /
``dop``, the predicates, ``kron`` / ``ikron`` / ``pkron`` / ``permute``,
``partial_trace``, ``expectation`` and the small helpers,
``ham_from_terms`` (host scipy assembly, as in quimb_tpu) and the two
device operators, the ELL :class:`SparseHam` and the per-term
:class:`LocalTermsHam`, with :func:`device_operator` choosing between
them. Kets are (d, 1) columns. A device operator is a plain object holding
tensors on one device; it has no parameters. quimb_tpu's scatter-free
formulations were chosen for the TPU; the port keeps them as the reference
does, and its COO path uses ``index_add_`` where quimb_tpu has
``segment_sum``. A reshape to one axis a subsystem merges runs of
subsystems that stay together first (:func:`dim_compress`), so that a
partial trace or permutation of many sites does not hit the bound on the
number of dimensions of a CUDA copy.
"""

import functools
import math
import numbers
import operator

import numpy as np
import scipy.sparse as sp
import torch

from .config import get_default_dtype, get_default_real_dtype
from .ops.backend import (complex_dtype, numpy_dtype, resolve_device,
                           to_device, to_host)

#: the attribute that :func:`ham_from_terms` sets on a sparse Hamiltonian
#: of one- and two-site terms: ``(dims, {sites: summed local matrix})``
#: (quimb_tpu's is ``_quimb_tpu_local_terms``)
LOCAL_TERMS_ATTR = "_quimb_torch_local_terms"


def prod(it):
    return functools.reduce(operator.mul, it, 1)


def isket(qob):
    shape = np.shape(qob)
    return len(shape) == 2 and shape[0] > 1 and shape[1] == 1


def isbra(qob):
    shape = np.shape(qob)
    return len(shape) == 2 and shape[0] == 1 and shape[1] > 1


def isop(qob):
    shape = np.shape(qob)
    return len(shape) == 2 and shape[0] > 1 and shape[1] > 1


def isvec(qob):
    return isket(qob) or isbra(qob)


def isscalarish(qob):
    return np.isscalar(qob) or (hasattr(qob, "shape")
                                and tuple(qob.shape) == ())


def isdense(qob):
    return isinstance(qob, (torch.Tensor, np.ndarray))


def issparse(qob):
    return sp.issparse(qob)


def _host(qob):
    return qob.toarray() if sp.issparse(qob) else to_host(qob)


def isreal(qob, **allclose_opts):
    """Whether ``qob`` has no imaginary part (within ``allclose``)."""
    data = _host(qob)
    return (not np.iscomplexobj(data)
            or np.allclose(data.imag, 0.0, **allclose_opts))


def isherm(qob, **allclose_opts):
    if sp.issparse(qob):
        return np.allclose((qob - qob.getH()).data, 0.0, **allclose_opts)
    a = _host(qob)
    return np.allclose(a, a.conj().T, **allclose_opts)


def ispos(qob, tol=1e-15):
    """Whether the hermitian ``qob`` has no eigenvalue below ``-tol``."""
    w = torch.linalg.eigvalsh(torch.as_tensor(_host(qob)))
    return bool((w > -tol).all())


def make_immutable(x):
    """Kept for quimb_tpu's API; tensors need no freezing here."""
    return x


def _real_dtype(dtype):
    return torch.empty(0, dtype=dtype).real.dtype


def _apply_dtype(op_dtype, x_dtype):
    """The dtype an operator of ``op_dtype`` applies in to a vector of
    ``x_dtype``: the vector's precision, complex if either is (quimb_tpu
    casts the operator to the vector's dtype, and so drops the imaginary
    part of a complex operator on a real vector)."""
    return complex_dtype(x_dtype) if op_dtype.is_complex else x_dtype


def quimbify(data, qtype=None, normalized=False, chopped=False,
             sparse=None, stype=None, dtype=None, device=None):
    """``data`` as a quantum object in ``dtype`` (complex128 by default):
    a ket (d, 1) for ``qtype="ket"`` or a 1-d input, a bra (1, d),
    conjugated, for ``"bra"``, a density operator for ``"dop"``. A tensor
    stays on its device unless ``device`` is given; host data goes to
    ``device``, the GPU by default. With ``sparse`` the result is a host
    scipy CSR matrix (quimb_tpu's is a JAX BCOO), which
    :func:`device_operator` takes to the device. ``stype`` (the sparse
    format) is accepted and ignored, as quimb_tpu ignores it."""
    dtype = dtype or get_default_dtype()
    if sp.issparse(data):
        data = data.toarray()
    if isinstance(data, torch.Tensor):
        x = data.to(device=None if device is None else resolve_device(device),
                    dtype=dtype)
    else:
        x = to_device(np.asarray(data), device=resolve_device(device),
                      dtype=dtype)
    if qtype in ("k", "ket"):
        x = torch.reshape(x, (-1, 1))
    elif qtype in ("b", "bra"):
        x = torch.conj(torch.reshape(x, (1, -1)))
    elif qtype in ("d", "r", "rho", "op", "dop"):
        if not (x.ndim == 2 and x.shape[0] == x.shape[1]):
            k = torch.reshape(x, (-1, 1))
            x = k @ dag(k)
    elif x.ndim == 1:
        x = torch.reshape(x, (-1, 1))
    if chopped:
        x = chop(x)
    if normalized:
        x = normalize(x)
    if sparse:
        return sp.csr_matrix(to_host(x))
    return x


qu = quimbify


def ket(data, **kwargs):
    return quimbify(data, qtype="ket", **kwargs)


def bra(data, **kwargs):
    return quimbify(data, qtype="bra", **kwargs)


def dop(data, **kwargs):
    return quimbify(data, qtype="dop", **kwargs)


def sparse_matrix(data, stype="csr", dtype=None):
    """A host scipy sparse matrix of ``data``."""
    return sp.coo_matrix(_host(data), dtype=dtype).asformat(stype)


def infer_size(p, base=2):
    """The number of subsystems of dimension ``base`` in ``p``."""
    d = max(np.shape(p))
    n = round(math.log(d, base))
    if base**n != d:
        raise ValueError(f"size {d} is not a power of {base}")
    return n


def dag(qob):
    """Hermitian conjugate."""
    return torch.conj(torch.swapaxes(qob, -2, -1))


def mul(x, y):
    """Element-wise product (quimb's ``mul``; the matrix product is
    :func:`dot`)."""
    if sp.issparse(x):
        return x.multiply(y)
    if sp.issparse(y):
        return y.multiply(x)
    return x * y


def dot(x, y):
    return x @ y


def vdot(a, b):
    """The inner product <a|b> of two kets."""
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def rdot(a, b):
    """The product of ``a`` as a row with ``b`` as a column, unconjugated."""
    return torch.squeeze(a.reshape(1, -1) @ b.reshape(-1, 1))


def ldmul(diag, mat):
    return diag.reshape(-1, 1) * mat


def rdmul(mat, diag):
    return mat * diag.reshape(1, -1)


def outer(a, b):
    return a.reshape(-1, 1) * torch.conj(b.reshape(1, -1))


def explt(l, t):
    return torch.exp((-1.0j * t) * l)


def normalize(qob, inplace=False):
    """A ket or bra over its 2-norm, a density operator over its trace."""
    if isop(qob):
        return qob / torch.trace(qob)
    return qob / torch.linalg.norm(qob)


normalize_ = nmlz = normalize


def chop(qob, tol=1e-15, inplace=False):
    """``qob`` with the entries below ``tol`` times its largest magnitude
    set to zero."""
    absx = torch.abs(qob)
    return torch.where(absx > tol * torch.max(absx), qob,
                       torch.zeros((), dtype=qob.dtype, device=qob.device))


chop_ = chop


def expectation(a, b):
    """|<a|b>|^2 of two vectors, <b|A|b> of an operator and a vector, or
    Re tr(a b) of two operators."""
    if isvec(a) and isvec(b):
        return torch.abs(vdot(a, b)) ** 2
    if isop(a) and isvec(b):
        b = b.reshape(-1, 1)
        return torch.real(torch.squeeze(dag(b) @ (a @ b)))
    if isvec(a) and isop(b):
        return expectation(b, a)
    return torch.real(torch.sum(a * b.T))


expec = expectation


def tr(a):
    return torch.trace(a)


trace = tr


def itrace(a, axes=(0, 1)):
    """The trace over one pair of axes, or over two sequences of axes
    traced pairwise."""
    if isinstance(axes[0], numbers.Integral):
        axes = ((axes[0],), (axes[1],))
    gone = set()
    for axis1, axis2 in zip(*axes):
        mod1 = sum(x < axis1 for x in gone)
        mod2 = sum(x < axis2 for x in gone)
        gone |= {axis1, axis2}
        a = torch.diagonal(a, dim1=axis1 - mod1, dim2=axis2 - mod2).sum(-1)
    return a


def dim_compress(dims, inds):
    """``dims`` with each run of neighbouring subsystems that are all in
    ``inds``, or all out of it, merged into one, and ``inds`` renumbered
    for the merged subsystems."""
    if isinstance(inds, numbers.Integral):
        inds = (inds,)
    inds = set(inds)
    new_dims, new_inds = [], []
    d_accum, in_target = 1, None
    for i, d in enumerate(dims):
        this_target = i in inds
        if in_target is None:
            in_target, d_accum = this_target, d
        elif this_target == in_target:
            d_accum *= d
        else:
            if in_target:
                new_inds.append(len(new_dims))
            new_dims.append(d_accum)
            in_target, d_accum = this_target, d
    if in_target:
        new_inds.append(len(new_dims))
    new_dims.append(d_accum)
    return tuple(new_dims), tuple(new_inds)


def kron(*ops, stype=None, coo_build=False, parallel=False, ownership=None,
         device=None):
    """Kronecker product of operators: a host scipy CSR matrix when any of
    them is sparse; else a tensor in their promoted dtype, on ``device``,
    or the first tensor's device, or the GPU. ``stype``, ``coo_build``,
    ``parallel`` and ``ownership`` (the sparse format, its assembly and a
    slice of rows) are accepted and ignored, as quimb_tpu ignores them."""
    if any(sp.issparse(op) for op in ops):
        return functools.reduce(
            lambda a, b: sp.kron(a, b, format="csr"),
            [op if sp.issparse(op) else sp.csr_matrix(to_host(op))
             for op in ops])
    if device is None:
        device = next((op.device for op in ops
                       if isinstance(op, torch.Tensor)), None)
    device = resolve_device(device)
    out = to_device(ops[0], device=device)
    for op in ops[1:]:
        op = to_device(op, device=device)
        dt = torch.promote_types(out.dtype, op.dtype)
        out = torch.kron(out.to(dt), op.to(dt))
    return out


def kronpow(a, p, **kron_opts):
    return kron(*(a,) * p, **kron_opts)


def eye(d, sparse=False, dtype=None, device=None):
    """The identity of dimension ``d``: a host scipy CSR matrix with
    ``sparse``, else a tensor on ``device``, the GPU by default."""
    dtype = dtype or get_default_dtype()
    if sparse:
        return sp.eye(d, dtype=numpy_dtype(dtype), format="csr")
    return torch.eye(d, dtype=dtype, device=resolve_device(device))


identity = eye
speye = functools.partial(eye, sparse=True)


def _find_dims_inds(dims, inds):
    if isinstance(inds, numbers.Integral):
        inds = (int(inds),)
    return tuple(dims), tuple(int(i) for i in inds)


def ikron(ops, dims, inds, sparse=None, stype=None, coo_build=False,
          parallel=False, ownership=None, device=None):
    """The operator(s) ``ops`` placed at the subsystems ``inds`` of a
    system of dimensions ``dims``, the identity elsewhere; an operator may
    span several neighbouring subsystems. A host scipy CSR matrix when
    any factor is sparse (or ``sparse``), else a tensor on ``device``, or
    the first tensor's device, or the GPU. ``stype``, ``coo_build``,
    ``parallel`` and ``ownership`` are ignored, as in :func:`kron`."""
    dims, inds = _find_dims_inds(dims, inds)
    if not isinstance(ops, (list, tuple)):
        ops = (ops,) * len(inds)
    ops = list(ops)
    if len(ops) == 1 and len(inds) > 1:
        ops = ops * len(inds)
    op_map = dict(zip(inds, ops))
    any_sparse = sparse or any(sp.issparse(op) for op in ops)
    if device is None and not any_sparse:
        device = next((op.device for op in ops
                       if isinstance(op, torch.Tensor)), None)
    factors, i, n = [], 0, len(dims)
    while i < n:
        if i in op_map:
            factors.append(op_map[i])
            # the operator may span several sites
            d_op, span, dd = op_map[i].shape[0], 1, dims[i]
            while dd < d_op:
                span += 1
                dd *= dims[i + span - 1]
            i += span
        else:
            d_id = 1
            while i < n and i not in op_map:
                d_id *= dims[i]
                i += 1
            factors.append(sp.eye(d_id, format="csr") if any_sparse
                           else eye(d_id, device=device))
    return kron(*factors, device=device)


eyepad = ikron


def pkron(op, dims, inds, **ikron_opts):
    """Like :func:`ikron`, for one operator acting on the (not necessarily
    neighbouring or ordered) subsystems ``inds``: placed on the leading
    subsystems, then permuted there."""
    dims, inds = _find_dims_inds(dims, inds)
    n = len(dims)
    if list(inds) == list(range(inds[0], inds[0] + len(inds))):
        return ikron(op, dims, inds[0], **ikron_opts)
    new_order = list(inds) + [i for i in range(n) if i not in inds]
    new_dims = [dims[i] for i in new_order]
    big = ikron(op, new_dims, tuple(range(len(inds))), **ikron_opts)
    if sp.issparse(big):
        big = to_device(big.toarray(), dtype=get_default_dtype(),
                        device=resolve_device(ikron_opts.get("device")))
    perm = [new_order.index(k) for k in range(n)]
    return permute(big, new_dims_order(dims, new_order), perm)


def new_dims_order(dims, order):
    return tuple(dims[i] for i in order)


def _merge_perm(dims, perm):
    """(dims, perm) with every run of source subsystems that the
    permutation keeps together and in order merged into one."""
    groups = [[perm[0]]]
    for a in perm[1:]:
        if a == groups[-1][-1] + 1:
            groups[-1].append(a)
        else:
            groups.append([a])
    order = sorted(range(len(groups)), key=lambda g: groups[g][0])
    new_dims = tuple(prod(dims[a] for a in groups[g]) for g in order)
    rank = {g: k for k, g in enumerate(order)}
    return new_dims, tuple(rank[g] for g in range(len(groups)))


def permute(p, dims, perm):
    """The subsystems of the state or operator ``p`` permuted: subsystem
    ``perm[k]`` of ``p`` becomes subsystem ``k``."""
    dims, perm = _merge_perm(tuple(dims), tuple(perm))
    n, d = len(dims), prod(dims)
    if isop(p):
        t = p.reshape(dims + dims).permute(perm + tuple(n + i for i in perm))
        return t.reshape(d, d)
    return p.reshape(dims).permute(perm).reshape(p.shape)


def partial_trace(p, dims, keep):
    """The reduced density operator of the subsystems ``keep`` of the
    state or density operator ``p`` on subsystems of dimensions
    ``dims``."""
    if isinstance(keep, numbers.Integral):
        keep = (int(keep),)
    dims, keep = dim_compress(tuple(dims), tuple(sorted(keep)))
    lose = tuple(i for i in range(len(dims)) if i not in keep)
    dk = prod(dims[i] for i in keep)
    if isvec(p):
        t = p.reshape(dims).permute(keep + lose).reshape(dk, -1)
        return t @ dag(t)
    n, dl = len(dims), prod(dims[i] for i in lose)
    t = p.reshape(dims + dims).permute(
        keep + lose + tuple(n + i for i in keep) + tuple(n + i for i in lose))
    return torch.einsum("ajbj->ab", t.reshape(dk, dl, dk, dl))


ptr = partial_trace


def ham_from_terms(terms, dims, sparse=False, dtype=None, device=None):
    """A Hamiltonian from ``terms = [(coeff, (op1, op2, ..), (site1, site2,
    ..)), ..]`` on sites of dimensions ``dims``, assembled on the host as a
    scipy CSR matrix. With ``sparse`` it returns that matrix in ``dtype``
    (complex128 by default), and when every term acts on at most two sites
    records their summed local matrices under :data:`LOCAL_TERMS_ATTR`, so
    that :func:`device_operator` can apply it term by term. Otherwise a
    dense tensor on ``device``, the GPU by default."""
    dtype = dtype or get_default_dtype()
    if not sparse:
        device = resolve_device(device)
    n = len(dims)
    H = sp.csr_matrix((prod(dims), prod(dims)), dtype=complex)
    for coeff, ops, sites in terms:
        # sparse factors: identity blocks between the operators
        factors, pos = [], 0
        for s, op in sorted(zip(sites, ops), key=lambda x: x[0]):
            if s > pos:
                factors.append(sp.eye(prod(dims[pos:s]), format="csr"))
            factors.append(sp.csr_matrix(to_host(op)))
            pos = s + 1
        if pos < n:
            factors.append(sp.eye(prod(dims[pos:n]), format="csr"))
        H = H + coeff * functools.reduce(
            lambda a, b: sp.kron(a, b, format="csr"), factors)
    H.eliminate_zeros()
    if not sparse:
        return to_device(H.toarray(), device=device, dtype=dtype)

    H = H.astype(numpy_dtype(dtype))
    if all(len(sites) <= 2 for _, _, sites in terms):
        combined = {}
        for coeff, ops, sites in terms:
            sites_ops = sorted(zip(sites, ops), key=lambda x: x[0])
            key = tuple(s for s, _ in sites_ops)
            mat = functools.reduce(
                np.kron, [to_host(op) for _, op in sites_ops]) * coeff
            combined[key] = combined[key] + mat if key in combined else mat
        setattr(H, LOCAL_TERMS_ATTR, (tuple(dims), combined))
    return H


class SparseHam:
    """A sparse Hamiltonian on a device in ELL (padded-row) format.

    Every row is padded to the largest count of nonzeros in a row ``K``,
    so the matvec is an (N, K) gather and a dense row sum, with no
    scatter. Where the padding would take more than 4x the raw nonzeros it
    keeps sorted COO triplets and sums the products into their rows with
    ``index_add_``. A real operator given as complex drops to the real
    dtype when no ``dtype`` is asked for.
    """

    def __init__(self, H, dtype=None, device=None):
        device = resolve_device(device)
        Hc = H.tocoo() if sp.issparse(H) else sp.coo_matrix(to_host(H))
        if dtype is None:
            dtype = get_default_dtype()
            if np.iscomplexobj(Hc.data) and np.allclose(Hc.data.imag, 0):
                Hc = Hc.copy()
                Hc.data = Hc.data.real
                dtype = _real_dtype(dtype)
        self.shape = Hc.shape
        self.dtype = dtype
        self.device = device

        n, nnz = Hc.shape[0], len(Hc.data)
        counts = np.bincount(Hc.row, minlength=n)
        k = int(counts.max()) if nnz else 1
        self._ell = nnz == 0 or n * k <= 4 * nnz
        order = np.argsort(Hc.row, kind="stable")
        r = Hc.row[order].astype(np.int64)
        c = Hc.col[order].astype(np.int32)
        v = Hc.data[order]
        if np.iscomplexobj(v) and not dtype.is_complex:
            v = v.real
        if self._ell:
            starts = np.zeros(n + 1, np.int64)
            np.cumsum(counts, out=starts[1:])
            pos = np.arange(nnz, dtype=np.int64) - starts[r]
            cols = np.zeros((n, k), np.int32)
            vals = np.zeros((n, k), v.dtype)
            cols[r, pos] = c
            vals[r, pos] = v
            self.rows = None
        else:
            cols, vals = c, v
            self.rows = to_device(r.astype(np.int32), device=device)
        self.cols = to_device(cols, device=device)
        self.vals = to_device(vals, device=device, dtype=dtype)

    def matvec(self, x):
        """``H @ x`` for x (N,) or a block of columns (N, m), in the dtype
        of :func:`_apply_dtype`."""
        dt = _apply_dtype(self.dtype, x.dtype)
        x = x.to(dt)
        vals = self.vals.to(dt if self.dtype.is_complex else _real_dtype(dt))
        tail = x.shape[1:]
        src = x.index_select(0, self.cols.reshape(-1))
        if self._ell:
            n, k = self.cols.shape
            vals = vals.reshape(n, k, *(1,) * len(tail))
            return torch.sum(vals * src.reshape(n, k, *tail), dim=1)
        contrib = vals.reshape(-1, *(1,) * len(tail)) * src
        out = torch.zeros((self.shape[0], *tail), dtype=contrib.dtype,
                          device=contrib.device)
        return out.index_add_(0, self.rows, contrib)

    def __matmul__(self, x):
        if x.ndim == 2 and x.shape[1] == 1:
            return torch.reshape(self.matvec(x[:, 0]), (-1, 1))
        return self.matvec(x)

    def to_dense(self):
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        if self._ell:
            rows = torch.arange(self.shape[0], device=out.device)[:, None]
            index = (rows.expand(self.cols.shape), self.cols.long())
        else:
            index = (self.rows.long(), self.cols.long())
        return out.index_put_(index, self.vals, accumulate=True)


class LocalTermsHam:
    """A Hamiltonian held as its local terms: a summed matrix per tuple of
    one or two sites, applied term by term.

    ``H @ v`` views ``v`` on the site grid and contracts each term's
    sites with its matrix, accumulating in place into the output, so no
    term copies the vector. For neighbouring sites that is one batched
    product ``(D, D) @ (pre, D, post)`` added by ``baddbmm_``; near the
    chain's end, where ``post`` is small, one GEMM ``(pre, D post) @ (m
    kron I_post)^T`` added by ``addmm_`` instead, widened to at least
    :attr:`GEMM_MIN_WIDTH` columns by the identity of the sites before
    the term. On an H100, at 2**20 complex128 entries, the batched form
    took 2.1 ms at post = 2 and a GEMM 4 or 8 wide 0.07-0.13 ms, against
    0.04 ms a bulk term. The mats are real when every term is; the
    matrices of each product, cast to the vector's dtype, are made once
    and cached.

    Parameters
    ----------
    dims : tuple of int
        Site dimensions of the product space.
    terms : dict[(site, ...), array]
        The summed local matrix of each one- or two-site tuple.
    """

    #: the widest ``D * post`` a term near the chain's end takes as one
    #: GEMM with ``m kron I_post``, and the fewest columns of that GEMM
    GEMM_WIDTH, GEMM_MIN_WIDTH = 64, 16

    def __init__(self, dims, terms, dtype=None, device=None):
        device = resolve_device(device)
        self.dims = tuple(int(d) for d in dims)
        n = prod(self.dims)
        self.shape = (n, n)
        real = all(np.allclose(np.asarray(m).imag, 0)
                   for m in terms.values())
        if dtype is None:
            dtype = get_default_real_dtype() if real else get_default_dtype()
        self.dtype = dtype
        self.device = device
        self.sites = tuple(sorted(terms))
        self.mats = tuple(
            to_device(np.asarray(terms[s]).real if real
                      else np.asarray(terms[s]), device=device, dtype=dtype)
            for s in self.sites)
        self._plans = {}

    def _plan(self, dtype, trailing):
        """Each term's product on vectors of ``dtype`` laid out (*dims,
        trailing): (kind, view shape, matrix), made once and cached."""
        key = (dtype, trailing)
        if key in self._plans:
            return self._plans[key]
        dims, plan = self.dims, []
        for sites, m in zip(self.sites, self.mats):
            m = m.to(dtype)
            i, j = sites[0], sites[-1]
            pre = prod(dims[:i])
            post = prod(dims[j + 1:]) * trailing
            if j - i > 1:
                di, dj, mid = dims[i], dims[j], prod(dims[i + 1:j])
                plan.append(("far", (pre, di, mid, dj, post),
                             m.reshape(di, dj, di, dj)))
                continue
            D = prod(dims[i:j + 1])
            if D * post <= self.GEMM_WIDTH:
                # I_wide kron m kron I_post, over the sites k..i-1 before
                # the term and all after it
                k, wide = i, 1
                while k > 0 and wide * D * post < self.GEMM_MIN_WIDTH:
                    k -= 1
                    wide *= dims[k]
                for f, left in ((wide, True), (post, False)):
                    if f > 1:
                        eye = torch.eye(f, dtype=dtype, device=m.device)
                        m = torch.kron(eye, m) if left else torch.kron(m,
                                                                       eye)
                plan.append(("gemm", (prod(dims[:k]), wide * D * post),
                             m.T))
            else:
                plan.append(("bmm", (pre, D, post), m.expand(pre, D, D)))
        self._plans[key] = plan
        return plan

    def _apply(self, v, trailing):
        """H on the flat ``v`` laid out (*dims, trailing): ``trailing``
        columns side by side."""
        out = torch.zeros_like(v)
        for kind, shape, m in self._plan(v.dtype, trailing):
            t, o = v.view(shape), out.view(shape)
            if kind == "gemm":
                o.addmm_(t, m)
            elif kind == "bmm":
                o.baddbmm_(m, t)
            else:
                o.add_(torch.einsum("pqij,aimjb->apmqb", m, t))
        return out

    def matvec(self, x):
        """``H @ x`` for a vector of any shape with N entries: the result
        has its shape and the dtype of :func:`_apply_dtype`."""
        v = torch.reshape(x, (-1,)).to(_apply_dtype(self.dtype, x.dtype))
        return torch.reshape(self._apply(v.contiguous(), 1), x.shape)

    def __matmul__(self, x):
        if x.ndim == 2:
            v = x.to(_apply_dtype(self.dtype, x.dtype)).contiguous()
            return self._apply(v.reshape(-1), x.shape[1]).reshape(x.shape)
        return self.matvec(x)

    def to_dense(self):
        return self @ torch.eye(self.shape[0], dtype=self.dtype,
                                device=self.device)


def device_operator(A, dtype=None, device=None):
    """The device form of a host sparse matrix, on ``device`` (the GPU by
    default): :class:`LocalTermsHam` when :func:`ham_from_terms` recorded
    its local terms, else the ELL :class:`SparseHam`."""
    lt = getattr(A, LOCAL_TERMS_ATTR, None)
    if lt is not None:
        dims, terms = lt
        return LocalTermsHam(dims, terms, dtype=dtype, device=device)
    return SparseHam(A, dtype=dtype, device=device)


# -- small helpers of quimb's API ---------------------------------------------

from math import (cos, exp, log, log2, log10, pi, sin,  # noqa: E402,F401
                  sqrt, tan)


class qarray(np.ndarray):
    """A ``numpy.ndarray`` with a compact repr and ``.H`` (reference
    ``qarray`` core.py:190), for host copies; tensors stay tensors."""

    def __new__(cls, input_array, dtype=None):
        return np.asarray(input_array, dtype=dtype).view(cls)

    @property
    def H(self):
        return self.conj().T

    def __repr__(self):
        with np.printoptions(precision=6, linewidth=120, suppress=True):
            s = np.ndarray.__repr__(np.asarray(self))
        return s.replace("array", "qarray", 1)


sparse = sparse_matrix


def _find_shape_of_nested_int_array(x):
    """The shape of a nested list structure of ints."""
    shape, sub = [], x
    while not isinstance(sub, (int, np.integer)):
        shape.append(len(sub))
        sub = sub[0]
    return tuple(shape)


def dim_map(dims, coos, cyclic=False, trim=False):
    """Flatten multi-dimensional ``dims`` and map coordinate tuples to flat
    indices (reference ``dim_map`` core.py:1761)."""
    if isinstance(dims, np.ndarray):
        szs, ndim = dims.shape, dims.ndim
    else:
        szs = _find_shape_of_nested_int_array(dims)
        ndim = len(szs)
    if ndim == 1 and coos and isinstance(coos[0], (int, np.integer)):
        coos = [(c,) for c in coos]
    coos = list(map(tuple, coos))
    if cyclic:
        coos = [tuple(c % s for c, s in zip(coo, szs)) for coo in coos]
    elif trim:
        coos = [coo for coo in coos
                if all(0 <= c < s for c, s in zip(coo, szs))]
    elif any(not (0 <= c < s) for coo in coos for c, s in zip(coo, szs)):
        raise ValueError("coordinates beyond dimension size")
    flat_dims = tuple(np.asarray(dims).flatten().tolist())
    strides = np.cumprod((1,) + szs[:0:-1])[::-1]
    inds = tuple(int(sum(c * st for c, st in zip(coo, strides)))
                 for coo in coos)
    return flat_dims, inds


__all__ = [
    "prod", "isket", "isbra", "isop", "isvec", "isscalarish", "isdense",
    "issparse", "isreal", "isherm", "ispos", "make_immutable", "quimbify",
    "qu", "ket", "bra", "dop", "sparse_matrix", "infer_size", "dag", "mul",
    "dot", "vdot", "rdot", "ldmul", "rdmul", "outer", "explt", "normalize",
    "normalize_", "nmlz", "chop", "chop_", "expectation", "expec", "tr",
    "trace", "itrace", "dim_compress", "kron", "kronpow", "eye",
    "identity", "speye", "ikron", "eyepad", "pkron", "new_dims_order",
    "permute", "partial_trace", "ptr", "ham_from_terms", "SparseHam",
    "LocalTermsHam", "device_operator", "qarray", "sparse", "dim_map",
    "cos", "exp", "log", "log2", "log10", "pi", "sin", "sqrt", "tan",
]
