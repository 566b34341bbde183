"""Carry arrays between quimb_tpu and quimb_torch.

The two packages share the uniform array layout of the DMRG engine —
MPO tensors ``(wl, wr, u, d)`` and MPS tensors ``(l, p, r)`` — so a
state or operator crosses as numpy arrays, with no reshaping.
"""

from .ops.backend import to_device, to_host


def from_tpu_arrays(Ws, As, device=None, dtype=None):
    """quimb_tpu's ``dmrg._mpo_uniform_arrays(H)`` and
    ``dmrg._mps_uniform_arrays(psi)`` (numpy arrays) -> the port's
    ``(ham_arrays, p0)`` tensor lists."""
    return ([to_device(W, device=device, dtype=dtype) for W in Ws],
            [to_device(A, device=device, dtype=dtype) for A in As])


def to_numpy(tensors):
    """A list of tensors -> a list of numpy arrays."""
    return [to_host(t) for t in tensors]
