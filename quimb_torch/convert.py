"""Carry arrays between quimb_tpu and quimb_torch.

The two packages share the uniform array layout of the DMRG engine —
MPO tensors ``(wl, wr, u, d)`` and MPS tensors ``(l, p, r)`` — so a
state or operator crosses as numpy arrays, with no reshaping. Tensors
land on ``device``, the GPU unless the caller names another.
"""

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


def to_numpy(tensors):
    """A list of tensors -> a list of numpy arrays."""
    return [to_host(t) for t in tensors]
