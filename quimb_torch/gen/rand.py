"""Random arrays with controllable seeding: the parts of quimb_tpu's
``gen/rand.py`` that the tensor-network layer uses (``randn``,
``seed_rand``).

quimb_tpu draws from JAX's PRNG, which torch cannot reproduce, so the
values differ; the shapes, dtypes, moments and the determinism under one
seed are the same. Draws are made by a ``torch.Generator`` on the device
of the result: a fresh one seeded with ``seed`` when it is given, else
one generator per device that :func:`seed_rand` reseeds.
"""

import threading

import numpy as np
import torch

from ..config import DEFAULT_DTYPE
from ..ops.backend import resolve_device, to_torch_dtype

_LOCK = threading.Lock()
_GENERATORS = {}
_SEED = [None]


def seed_rand(seed):
    """Seed all later draws made without a ``seed``."""
    with _LOCK:
        _SEED[0] = seed
        _GENERATORS.clear()


def _generator(device, seed=None):
    if seed is not None:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        return gen
    with _LOCK:
        gen = _GENERATORS.get(device)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(_SEED[0] if _SEED[0] is not None
                            else int(np.random.SeedSequence().entropy
                                     % (2**63)))
            _GENERATORS[device] = gen
    return gen


def randn(shape=(), dtype=None, scale=1.0, loc=0.0, seed=None,
          dist="normal", device=None):
    """Random tensor of ``shape`` on ``device`` (the GPU unless given):
    gaussian by default; a complex dtype gets independent real and
    imaginary parts, each of unit variance, as in quimb_tpu."""
    if isinstance(shape, int):
        shape = (shape,)
    shape = tuple(shape)
    dtype = to_torch_dtype(dtype or DEFAULT_DTYPE)
    device = resolve_device(device)
    rdt = torch.empty(0, dtype=dtype).real.dtype
    gen = _generator(device, seed)

    def draw():
        if dist == "normal":
            return torch.randn(shape, generator=gen, dtype=rdt,
                               device=device)
        if dist == "uniform":
            return torch.rand(shape, generator=gen, dtype=rdt,
                              device=device) - 0.5
        if dist == "rademacher":
            return 2 * torch.randint(0, 2, shape, generator=gen,
                                     device=device).to(rdt) - 1
        if dist == "exp":
            u = torch.rand(shape, generator=gen, dtype=rdt, device=device)
            return -torch.log1p(-u)
        raise ValueError(f"unknown distribution {dist}")

    out = torch.complex(draw(), draw()) if dtype.is_complex else draw()
    if scale != 1.0:
        out = out * scale
    if loc != 0.0:
        out = out + loc
    return out.to(dtype)
