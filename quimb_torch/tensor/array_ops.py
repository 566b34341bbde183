"""Array operations of the tensor-network layer: the conversion of a
tensor's data, fuse / reshape, norms, and the host-side structure finders
(diagonals, anti-diagonals, trivial columns).

Port of quimb_tpu's ``tensor/array_ops.py`` to torch. A tensor's data is
a ``torch.Tensor``, or a host numpy array inside the
``contract_backend("numpy")`` context, as in quimb_tpu. The structure
finders are setup-time utilities and run on the host.
"""

import functools

import numpy as np
import torch

from ..ops.backend import resolve_device, to_host, to_torch_dtype
from ..ops.backend import to_device as _to_device


def asarray(x):
    """``x`` as a tensor's data: a torch tensor keeps its device; a numpy
    array stays on the host inside ``contract_backend("numpy")``; any
    other array-like lands on the default device, the GPU (quimb_tpu's
    ``asarray`` puts it on JAX's default device)."""
    if x.__class__.__name__ == "PArray":
        # a lazy parametrized array: kept unmaterialized
        return x
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, np.generic):
        x = np.asarray(x)
    if isinstance(x, np.ndarray) and x.dtype != object:
        from ..ops.contraction import get_contract_backend

        if get_contract_backend() == "numpy":
            return x
    return _to_device(x, device=resolve_device(None))


def like(x, ref):
    """Array-like ``x`` as a tensor on the device, and in the dtype, of the
    tensor ``ref`` (a numpy array when ``ref`` is one)."""
    if isinstance(ref, np.ndarray):
        return np.asarray(to_host(x)).astype(ref.dtype)
    if isinstance(x, torch.Tensor):
        return x.to(device=ref.device, dtype=ref.dtype)
    return torch.as_tensor(np.array(x), device=ref.device).to(ref.dtype)


def astype(x, dtype):
    """``x`` in ``dtype`` (a torch dtype, numpy dtype or dtype name)."""
    if isinstance(x, np.ndarray):
        return x.astype(np.dtype(str(dtype).replace("torch.", "")))
    return x.to(to_torch_dtype(dtype))


def ndim(x):
    if x.__class__.__name__ == "PArray":
        return x.ndim
    return len(x.shape)


def do_conj(x):
    """The complex conjugate, materialised (torch's lazy conjugate bit is
    resolved); a real tensor is returned as it is."""
    if isinstance(x, np.ndarray):
        return np.conj(x)
    if not x.is_complex():
        return x
    return torch.conj_physical(x)


def norm_fro(x):
    """Frobenius norm."""
    if isinstance(x, np.ndarray):
        return np.linalg.norm(x.reshape(-1))
    return torch.linalg.norm(x.reshape(-1))


def sensibly_scale(x):
    """Scale an array to have frobenius norm equal to its number of
    elements**0.5 (useful to avoid under/overflow)."""
    size = x.size if isinstance(x, np.ndarray) else x.numel()
    return x / (norm_fro(x) / size**0.5)


@functools.lru_cache(2**10)
def calc_fuse_perm_and_shape(shape, axes_groups):
    """The permutation and final shape that fuse ``axes_groups`` of an
    array with ``shape``, each group placed at the position of its first
    axis (cached on the host)."""
    ndim_ = len(shape)
    grouped = [ax for grp in axes_groups for ax in grp]
    groups = [tuple(g) for g in axes_groups]
    order = []
    new_shape = []
    placed = set()
    for ax in range(ndim_):
        if ax in placed:
            continue
        ingroup = next((grp for grp in groups if ax == grp[0]), None)
        if ingroup is not None:
            order.extend(ingroup)
            placed.update(ingroup)
            new_shape.append(int(np.prod([shape[a] for a in ingroup])))
        elif ax not in grouped:
            order.append(ax)
            placed.add(ax)
            new_shape.append(shape[ax])
    return tuple(order), tuple(new_shape)


def transpose(x, perm):
    if isinstance(x, np.ndarray):
        return np.transpose(x, perm)
    return x.permute(*perm)


def fuse(x, *axes_groups):
    """Fuse multiple groups of axes into single axes, each group placed
    at the position of its first member."""
    perm, new_shape = calc_fuse_perm_and_shape(
        tuple(x.shape), tuple(map(tuple, axes_groups))
    )
    return transpose(x, perm).reshape(new_shape)


def reshape(x, shape):
    return x.reshape(tuple(shape))


def multiply_diagonal(x, v, axis):
    """Multiply ``x`` by a vector ``v`` broadcast along ``axis`` — i.e.
    contract a diagonal matrix diag(v) into that axis."""
    shape = [1] * ndim(x)
    shape[axis] = -1
    return x * like(v, x).reshape(shape)


def tensordot_axis(x, M, ax, m_axis):
    """Contract axis ``m_axis`` of the matrix ``M`` into axis ``ax`` of
    ``x``, keeping the new axis (the other one of ``M``) at ``ax``."""
    if isinstance(x, np.ndarray):
        M = to_host(M)
        return np.moveaxis(np.tensordot(x, M, axes=(ax, m_axis)), -1, ax)
    M = torch.as_tensor(M, device=x.device)
    if M.dtype != x.dtype:
        dt = torch.promote_types(M.dtype, x.dtype)
        x, M = x.to(dt), M.to(dt)
    return torch.moveaxis(torch.tensordot(x, M, dims=([ax], [m_axis])),
                          -1, ax)


def pad(x, pads):
    """Zero-pad ``x`` by ``pads``, a ``(before, after)`` pair per axis."""
    if isinstance(x, np.ndarray):
        return np.pad(x, pads)
    flat = []
    for before, after in reversed(pads):
        flat += [before, after]
    return torch.nn.functional.pad(x, flat)


def align_axes(*arrays, axes):
    """No-op placeholder for block-sparse alignment (dense arrays are
    always aligned)."""
    return arrays


def isblocksparse(x):
    return False


def isfermionic(x):
    return False


# -- host-side structure finders ---------------------------------------------


def find_diag_axes(x, atol=1e-12):
    """Find a pair of axes along which ``x`` is diagonal (zero whenever
    the two indices differ), if any."""
    xh = to_host(x)
    nd = xh.ndim
    for i in range(nd):
        for j in range(i + 1, nd):
            if xh.shape[i] != xh.shape[j]:
                continue
            d = xh.shape[i]
            y = np.moveaxis(xh, (i, j), (0, 1)).reshape(d, d, -1)
            offdiag = y.copy()
            offdiag[np.arange(d), np.arange(d)] = 0
            if np.abs(offdiag).max(initial=0) <= atol:
                return (i, j)
    return None


def find_antidiag_axes(x, atol=1e-12):
    """Find a pair of axes along which ``x`` is anti-diagonal, if any."""
    xh = to_host(x)
    nd = xh.ndim
    for i in range(nd):
        for j in range(i + 1, nd):
            if xh.shape[i] != xh.shape[j]:
                continue
            d = xh.shape[i]
            y = np.moveaxis(xh, (i, j), (0, 1)).reshape(d, d, -1)
            offanti = y.copy()
            offanti[np.arange(d), d - 1 - np.arange(d)] = 0
            if np.abs(offanti).max(initial=0) <= atol:
                return (i, j)
    return None


def find_columns(x, atol=1e-12):
    """Find an axis with only a single nonzero slice — i.e. the tensor
    is a 'column' along it — returning (axis, col_index)."""
    xh = to_host(x)
    nd = xh.ndim
    for i in range(nd):
        y = np.moveaxis(xh, i, 0).reshape(xh.shape[i], -1)
        nonzero = np.abs(y).max(axis=1) > atol
        if nonzero.sum() == 1:
            return (i, int(np.argmax(nonzero)))
    return None


__all__ = [
    "align_axes", "asarray", "astype", "calc_fuse_perm_and_shape",
    "do_conj", "find_antidiag_axes", "find_columns", "find_diag_axes",
    "fuse", "isblocksparse", "isfermionic", "like", "multiply_diagonal",
    "ndim", "norm_fro", "pad", "reshape", "sensibly_scale",
    "tensordot_axis", "to_host", "transpose",
]
