"""The exact layer: kets, Kronecker products and Hamiltonians as sums of
local terms, with the device operators that apply them.

Port of the parts of ``quimb_tpu/core.py`` that the exact solvers run:
``quimbify`` / ``qu`` / ``ket``, ``dag``, ``kron``, ``ham_from_terms``
(host scipy assembly, as in quimb_tpu) and the two device operators, the
ELL :class:`SparseHam` and the per-term :class:`LocalTermsHam`, with
:func:`device_operator` choosing between them. Kets are (d, 1) columns. A
device operator is a plain object holding tensors on one device; it has no
parameters. quimb_tpu's scatter-free formulations were chosen for the TPU;
the port keeps them as the reference does, and its COO path uses
``index_add_`` where quimb_tpu has ``segment_sum``.
"""

import functools
import operator

import numpy as np
import scipy.sparse as sp
import torch

from .config import DEFAULT_DTYPE
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


def isop(qob):
    shape = np.shape(qob)
    return len(shape) == 2 and shape[0] > 1 and shape[1] > 1


def _real_dtype(dtype):
    return torch.empty(0, dtype=dtype).real.dtype


def _apply_dtype(op_dtype, x_dtype):
    """The dtype an operator of ``op_dtype`` applies in to a vector of
    ``x_dtype``: the vector's precision, complex if either is (quimb_tpu
    casts the operator to the vector's dtype, and so drops the imaginary
    part of a complex operator on a real vector)."""
    return complex_dtype(x_dtype) if op_dtype.is_complex else x_dtype


def quimbify(data, qtype=None, normalized=False, dtype=None, device=None):
    """``data`` as a quantum object in ``dtype`` (complex128 by default):
    a ket (d, 1) for ``qtype="ket"`` or a 1-d input, a bra (1, d),
    conjugated, for ``"bra"``, a density operator for ``"dop"``. A tensor
    stays on its device unless ``device`` is given; host data goes to
    ``device``, the GPU by default."""
    dtype = dtype or DEFAULT_DTYPE
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
    if normalized:
        x = x / (torch.trace(x) if isop(x) else torch.linalg.norm(x))
    return x


qu = quimbify


def ket(data, **kwargs):
    return quimbify(data, qtype="ket", **kwargs)


def dag(qob):
    """Hermitian conjugate."""
    return torch.conj(torch.swapaxes(qob, -2, -1))


def kron(*ops, device=None):
    """Kronecker product of operators: a host scipy CSR matrix when any of
    them is sparse; else a tensor in their promoted dtype, on ``device``,
    or the first tensor's device, or the GPU."""
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


def ham_from_terms(terms, dims, sparse=False, dtype=None, device=None):
    """A Hamiltonian from ``terms = [(coeff, (op1, op2, ..), (site1, site2,
    ..)), ..]`` on sites of dimensions ``dims``, assembled on the host as a
    scipy CSR matrix. With ``sparse`` it returns that matrix in ``dtype``
    (complex128 by default), and when every term acts on at most two sites
    records their summed local matrices under :data:`LOCAL_TERMS_ATTR`, so
    that :func:`device_operator` can apply it term by term. Otherwise a
    dense tensor on ``device``, the GPU by default."""
    dtype = dtype or DEFAULT_DTYPE
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
            dtype = DEFAULT_DTYPE
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
            dtype = _real_dtype(DEFAULT_DTYPE) if real else DEFAULT_DTYPE
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
