"""``TNLinearOperator``: a tensor network acting lazily as a matrix.

Port of quimb_tpu's ``tensor/linop.py`` (reference ``TNLinearOperator``
tensor_core.py:11989, cached expressions :12085-12092). Each product
runs one cached contraction expression (one per key: matvec, rmatvec,
and matmat per batch size) on the device of the network's tensors. A
torch tensor in gives a torch tensor out on that device; a numpy array
in (scipy's interface) gives a numpy array out.
"""

import math

import numpy as np
import torch

from ..ops.contraction import array_contract_expression
from .core import Tensor, TensorNetwork, asinds

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.complex64: np.complex64, torch.complex128: np.complex128}


class TNLinearOperator:
    """A tensor network as a linear operator mapping vectors over
    ``right_inds`` to vectors over ``left_inds``."""

    def __init__(self, tn, left_inds, right_inds, ldims=None, rdims=None,
                 optimize=None, backend=None):
        if isinstance(tn, (list, tuple)):
            tn = TensorNetwork(tn, virtual=True, check_collisions=False)
        elif isinstance(tn, Tensor):
            tn = TensorNetwork((tn,), virtual=True, check_collisions=False)
        self.tn = tn
        self.left_inds = asinds(left_inds)
        self.right_inds = asinds(right_inds)
        self.ldims = tuple(ldims if ldims is not None
                           else (tn.ind_size(ix) for ix in self.left_inds))
        self.rdims = tuple(rdims if rdims is not None
                           else (tn.ind_size(ix) for ix in self.right_inds))
        self.optimize = optimize
        self.dl = math.prod(self.ldims)
        self.dr = math.prod(self.rdims)
        self.shape = (self.dl, self.dr)
        self.dtype = tn.dtype
        self.device = next(iter(tn.tensor_map.values())).data.device
        self._exprs = {}

    @property
    def arrays(self):
        return tuple(t.data for t in self.tn.tensor_map.values())

    def _get_expr(self, key, extra_in, output, extra_shape):
        expr = self._exprs.get(key)
        if expr is None:
            tensors = tuple(self.tn.tensor_map.values())
            expr = array_contract_expression(
                [t.inds for t in tensors] + [extra_in], output,
                shapes=[t.shape for t in tensors] + [extra_shape],
                optimize=self.optimize)
            self._exprs[key] = expr
        return expr

    def matvec_fn(self):
        """``(fn, arrays)``: ``fn(arrays, v)`` maps a tensor-shaped vector
        (shape ``rdims``) to one of shape ``ldims``."""
        expr = self._get_expr("mv", self.right_inds, self.left_inds,
                              self.rdims)
        return (lambda arrays, v: expr(*arrays, v)), self.arrays

    def _in(self, v):
        host = not isinstance(v, torch.Tensor)
        v = torch.as_tensor(v, device=self.device)
        if v.dtype != self.dtype:
            v = v.to(self.dtype)
        return v, host

    @staticmethod
    def _out(x, host):
        return x.resolve_conj().cpu().numpy() if host else x

    def matvec(self, v):
        v, host = self._in(v)
        fn, arrays = self.matvec_fn()
        return self._out(fn(arrays, v.reshape(self.rdims)).reshape(self.dl),
                         host)

    def rmatvec(self, v):
        """``A^H v``, as ``conj(A^T conj(v))``."""
        v, host = self._in(v)
        expr = self._get_expr("rmv", self.left_inds, self.right_inds,
                              self.ldims)
        out = expr(*(a.conj() for a in self.arrays),
                   v.reshape(self.ldims).conj()).conj()
        return self._out(out.reshape(self.dr), host)

    def matmat(self, X):
        """``A X`` for a matrix ``X`` of shape ``(dr, k)``: one
        contraction with the batch index open."""
        X, host = self._in(X)
        k = X.shape[1]
        bix = "__batch__"
        expr = self._get_expr(("mm", k), (*self.right_inds, bix),
                              (*self.left_inds, bix), (*self.rdims, k))
        out = expr(*self.arrays, X.reshape(*self.rdims, k))
        return self._out(out.reshape(self.dl, k), host)

    _matvec, _rmatvec, _matmat = matvec, rmatvec, matmat

    def to_dense(self, optimize=None):
        """The operator as an explicit matrix, on its device."""
        return self.tn.to_dense(self.left_inds, self.right_inds,
                                optimize=optimize or self.optimize)

    toarray = to_dense

    @property
    def A(self):
        return self.to_dense()

    def conj(self):
        """The complex conjugate operator (the same index structure)."""
        return TNLinearOperator(self.tn.conj(), self.left_inds,
                                self.right_inds, ldims=self.ldims,
                                rdims=self.rdims, optimize=self.optimize)

    def copy(self, conj=False, transpose=False):
        tn = self.tn.conj() if conj else self.tn.copy()
        if transpose:
            return TNLinearOperator(tn, self.right_inds, self.left_inds,
                                    self.rdims, self.ldims,
                                    optimize=self.optimize)
        return TNLinearOperator(tn, self.left_inds, self.right_inds,
                                self.ldims, self.rdims,
                                optimize=self.optimize)

    @property
    def H(self):
        return TNLinearOperator(self.tn.conj(), self.right_inds,
                                self.left_inds, self.rdims, self.ldims,
                                optimize=self.optimize)

    def aslinearoperator(self):
        """As a scipy ``LinearOperator`` on host arrays."""
        import scipy.sparse.linalg as spla

        return spla.LinearOperator(
            shape=self.shape, dtype=_NP_DTYPES[self.dtype],
            matvec=lambda v: self.matvec(np.asarray(v).reshape(-1)),
            rmatvec=lambda v: self.rmatvec(np.asarray(v).reshape(-1)),
            matmat=lambda X: self.matmat(np.asarray(X)))
