"""Carry arrays and operators between quimb_tpu and quimb_torch.

The two packages share the uniform array layout of the DMRG engine —
MPO tensors ``(wl, wr, u, d)`` and MPS tensors ``(l, p, r)`` — so a
state or operator crosses as numpy arrays, with no reshaping; a sparse
Hamiltonian of the exact layer crosses as its scipy matrix; a tensor or
a tensor network crosses with its arrays read as numpy arrays and its
``inds`` and ``tags`` kept; a circuit crosses as its list of gates.
Tensors land on ``device``, the GPU unless the caller names another.
"""

import numpy as np

from .core import LocalTermsHam, SparseHam
from .ops.backend import resolve_device, to_device, to_host


def from_tpu_mps(arrays, device=None, dtype=None):
    """A quimb_tpu MPS's site arrays as ``(l, p, r)`` numpy arrays, its
    ends padded with size-1 bonds (``dmrg._mps_uniform_arrays(psi)``) ->
    the port's list of tensors. quimb_tpu draws random states from JAX's
    generator, which torch cannot reproduce: carry them across with this."""
    device = resolve_device(device)
    return [to_device(A, device=device, dtype=dtype) for A in arrays]


def from_tpu_arrays(Ws, As, device=None, dtype=None):
    """quimb_tpu's ``dmrg._mpo_uniform_arrays(H)`` and
    ``dmrg._mps_uniform_arrays(psi)`` (numpy arrays) -> the port's
    ``(ham_arrays, p0)`` tensor lists."""
    device = resolve_device(device)
    return ([to_device(W, device=device, dtype=dtype) for W in Ws],
            from_tpu_mps(As, device=device, dtype=dtype))


def from_tpu_operator(H, device=None):
    """A scipy matrix from quimb_tpu's ``ham_from_terms(..., sparse=True)``
    -> the port's :class:`LocalTermsHam` of the local terms quimb_tpu
    recorded on it (``H._quimb_tpu_local_terms``: a tuple and numpy
    arrays, so nothing of JAX), or a :class:`SparseHam` of the matrix
    where it recorded none."""
    lt = getattr(H, "_quimb_tpu_local_terms", None)
    if lt is not None:
        dims, terms = lt
        return LocalTermsHam(dims, terms, device=device)
    return SparseHam(H, device=device)


def from_tpu_tensor(t, device=None):
    """A quimb_tpu ``Tensor`` (or any object with ``data``, ``inds``,
    ``tags`` and ``left_inds``) -> the port's :class:`Tensor` with the same
    indices and tags, its data read through ``np.asarray``."""
    from .tensor.core import Tensor

    data = to_device(np.asarray(t.data), device=resolve_device(device))
    return Tensor(data, inds=tuple(t.inds), tags=tuple(t.tags),
                  left_inds=getattr(t, "left_inds", None))


def from_tpu_tensor_network(tn, device=None):
    """A quimb_tpu ``TensorNetwork`` -> the port's :class:`TensorNetwork`
    of the same tensors, in the same order, with its ``exponent``."""
    from .tensor.core import TensorNetwork

    new = TensorNetwork([from_tpu_tensor(t, device=device)
                         for t in tn.tensor_map.values()], virtual=True)
    new.exponent = getattr(tn, "exponent", 0.0)
    return new


def from_tpu_gates(gates):
    """quimb_tpu's ``Circuit.gates`` -> the port's ``Gate`` objects, with
    the same label, parameters, qubits, controls, round, parametrization
    and tags; a raw gate's array is read as a numpy array. A circuit's
    gates are its parameters: ``Circuit.from_gates(from_tpu_gates(...))``
    rebuilds any quimb_tpu circuit in the port."""
    from .tensor.circuit.gates import Gate

    return [
        Gate(g.label, g.params, g.qubits, controls=g.controls,
             round=g.round, parametrize=g.parametrize, tags=g.tags,
             array=None if g.label != "RAW" else to_host(g.array))
        for g in gates
    ]


def to_numpy(tensors):
    """A list of tensors -> a list of numpy arrays."""
    return [to_host(t) for t in tensors]
