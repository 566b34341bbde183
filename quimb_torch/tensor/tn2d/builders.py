"""PEPS / PEPO builders (port of quimb_tpu's ``tensor/tn2d/builders.py``,
the 2D slice of the reference ``tensor_builder.py``).

Every builder puts its tensors on ``device``, the GPU unless given
another; without CUDA a call with no device raises. ``PEPS_rand`` and
``PEPO_rand`` draw from the port's seeded ``randn``: quimb_tpu draws from
JAX's generator, which torch cannot reproduce, so the values differ while
the shapes, order and seeding scheme (``seed + site number``) are the
same. Carry quimb_tpu's arrays across with ``convert.from_tpu_peps``.
"""

import itertools

import numpy as np
import torch

from ...config import get_default_real_dtype
from ...gen.rand import randn
from ...ops.backend import resolve_device, to_device, to_torch_dtype
from .core import PEPO, PEPS


def _bond_shape(i, j, Lx, Ly, bond_dim):
    """The virtual axes of site (i, j) in 'urdl' order, edge bonds
    dropped."""
    return [bond_dim] * sum((i < Lx - 1, j < Ly - 1, i > 0, j > 0))


def PEPS_rand(Lx, Ly, bond_dim, phys_dim=2, normalize=False, dtype=None,
              seed=None, device=None, **peps_opts):
    """Random PEPS of shape (Lx, Ly) with given bond dimension."""
    dtype = dtype or get_default_real_dtype()
    arrays = []
    s = 0
    for i in range(Lx):
        row = []
        for j in range(Ly):
            shape = _bond_shape(i, j, Lx, Ly, bond_dim) + [phys_dim]
            row.append(randn(
                tuple(shape), dtype=dtype,
                seed=None if seed is None else seed + s, device=device,
            ))
            s += 1
        arrays.append(row)
    psi = PEPS(arrays, shape="urdlp", **peps_opts)
    if normalize:
        psi.normalize()
    return psi


def PEPS_product_state(site_map, Lx=None, Ly=None, dtype=None, device=None,
                       **peps_opts):
    """PEPS from a map of (i, j) -> single-site vector, or a 2D
    nested sequence of vectors (reference ``PEPS.product_state``
    tn2d/core.py:4980 accepts both)."""
    if not isinstance(site_map, dict):
        rows = list(site_map)
        site_map = {
            (i, j): v
            for i, row in enumerate(rows)
            for j, v in enumerate(row)
        }
    if Lx is None:
        Lx = max(c[0] for c in site_map) + 1
    if Ly is None:
        Ly = max(c[1] for c in site_map) + 1
    device = resolve_device(device)
    dtype = None if dtype is None else to_torch_dtype(dtype)
    arrays = []
    for i in range(Lx):
        row = []
        for j in range(Ly):
            v = to_device(site_map[(i, j)], device=device,
                          dtype=dtype).reshape(-1)
            shape = _bond_shape(i, j, Lx, Ly, 1) + [v.numel()]
            row.append(v.reshape(shape))
        arrays.append(row)
    return PEPS(arrays, shape="urdlp", **peps_opts)


def PEPS_computational_state(binary, Lx=None, Ly=None, dtype=None,
                             device=None, **peps_opts):
    """PEPS for a computational product state. ``binary`` may be a
    string (row-major) or 2D array of 0/1."""
    dtype = to_torch_dtype(dtype or get_default_real_dtype())
    if isinstance(binary, str):
        if Lx is None or Ly is None:
            raise ValueError("need Lx, Ly for a flat string")
        arr = np.array([int(b) for b in binary]).reshape(Lx, Ly)
    else:
        arr = np.asarray(binary)
        Lx, Ly = arr.shape
    site_map = {}
    for i, j in itertools.product(range(Lx), range(Ly)):
        v = np.zeros(2)
        v[arr[i, j]] = 1.0
        site_map[(i, j)] = v
    return PEPS_product_state(site_map, Lx, Ly, dtype=dtype, device=device,
                              **peps_opts)


def PEPS_zeros(Lx, Ly, bond_dim, phys_dim=2, dtype=None, device=None,
               **peps_opts):
    dtype = to_torch_dtype(dtype or get_default_real_dtype())
    device = resolve_device(device)
    arrays = [
        [torch.zeros(_bond_shape(i, j, Lx, Ly, bond_dim) + [phys_dim],
                     dtype=dtype, device=device) for j in range(Ly)]
        for i in range(Lx)
    ]
    return PEPS(arrays, shape="urdlp", **peps_opts)


def PEPO_identity(Lx, Ly, phys_dim=2, dtype=None, device=None,
                  **pepo_opts):
    """Identity PEPO."""
    dtype = to_torch_dtype(dtype or get_default_real_dtype())
    II = torch.eye(phys_dim, dtype=dtype, device=resolve_device(device))
    arrays = []
    for i in range(Lx):
        row = []
        for j in range(Ly):
            nb = sum((i < Lx - 1, j < Ly - 1, i > 0, j > 0))
            row.append(II.reshape((1,) * nb + (phys_dim, phys_dim)))
        arrays.append(row)
    return PEPO(arrays, shape="urdlbk", **pepo_opts)


def PEPO_rand(Lx, Ly, bond_dim, phys_dim=2, herm=False, dtype=None,
              seed=None, device=None, **pepo_opts):
    dtype = dtype or get_default_real_dtype()
    arrays = []
    s = 0
    for i in range(Lx):
        row = []
        for j in range(Ly):
            shape = _bond_shape(i, j, Lx, Ly, bond_dim) + [phys_dim,
                                                            phys_dim]
            a = randn(tuple(shape), dtype=dtype,
                      seed=None if seed is None else seed + s,
                      device=device)
            if herm:
                a = a + a.transpose(-2, -1).conj()
            row.append(a)
            s += 1
        arrays.append(row)
    return PEPO(arrays, shape="urdlbk", **pepo_opts)


def PEPO_product_operator(arrays, device=None, **pepo_opts):
    """Bond-dimension-1 PEPO of a tensor product of one-site operators
    ``arrays[i][j]`` (reference ``PEPO_product_operator``
    tensor_builder.py:4655)."""
    arrays = tuple(tuple(x for x in xs) for xs in arrays)
    Lx, Ly = len(arrays), len(arrays[0])
    device = resolve_device(device)
    reshaped = []
    for i in range(Lx):
        row = []
        for j in range(Ly):
            arr = to_device(arrays[i][j], device=device)
            shape = _bond_shape(i, j, Lx, Ly, 1) + list(arr.shape)
            row.append(arr.reshape(shape))
        reshaped.append(row)
    return PEPO(reshaped, shape="urdlbk", **pepo_opts)
