"""Random arrays with controllable seeding: the parts of quimb_tpu's
``gen/rand.py`` that the tensor-network layer and the network builders use
(``randn``, ``seed_rand``, ``get_rand_fill_fn``, ``rand_phase``).

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


def _draw(shape, rdt, dist, gen, device):
    """One real draw of ``shape`` from ``gen`` in the distribution ``dist``."""
    if dist == "normal":
        return torch.randn(shape, generator=gen, dtype=rdt, device=device)
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


def _randn_from(gen, shape, dtype, scale, loc, dist, device):
    rdt = torch.empty(0, dtype=dtype).real.dtype
    out = _draw(shape, rdt, dist, gen, device)
    if dtype.is_complex:
        out = torch.complex(out, _draw(shape, rdt, dist, gen, device))
    if scale != 1.0:
        out = out * scale
    if loc != 0.0:
        out = out + loc
    return out.to(dtype)


def randn(shape=(), dtype=None, scale=1.0, loc=0.0, seed=None,
          dist="normal", device=None):
    """Random tensor of ``shape`` on ``device`` (the GPU unless given):
    gaussian by default; a complex dtype gets independent real and
    imaginary parts, each of unit variance, as in quimb_tpu."""
    if isinstance(shape, int):
        shape = (shape,)
    dtype = to_torch_dtype(dtype or DEFAULT_DTYPE)
    device = resolve_device(device)
    return _randn_from(_generator(device, seed), tuple(shape), dtype, scale,
                       loc, dist, device)


def get_rand_fill_fn(dist="normal", loc=0.0, scale=1.0, seed=None,
                     dtype=None, device=None):
    """A stateful ``fill_fn(shape) -> tensor`` on ``device`` (the GPU
    unless given), drawing from one generator seeded ``seed`` (reference
    ``get_rand_fill_fn`` gen/rand.py:322): successive calls draw fresh
    values, and two closures of one seed draw the same sequence."""
    dtype = to_torch_dtype(dtype or DEFAULT_DTYPE)
    device = resolve_device(device)
    gen = _generator(device, seed)
    if seed is None:
        # a private stream, seeded from the shared one, so the closure's
        # draws do not depend on other draws made meanwhile
        sub = torch.Generator(device=device)
        sub.manual_seed(int(torch.randint(
            0, 2**62, (), generator=gen, device=device)))
        gen = sub

    def fill_fn(shape=()):
        return _randn_from(gen, tuple(shape), dtype, scale, loc, dist,
                           device)

    return fill_fn


def rand_phase(shape, dtype=None, seed=None, device=None):
    """Random pure phases ``e^{i theta}``, theta uniform in [0, 2 pi), in a
    complex ``dtype`` on ``device`` (the GPU unless given)."""
    dtype = to_torch_dtype(dtype or DEFAULT_DTYPE)
    if not dtype.is_complex:
        raise ValueError("rand_phase needs a complex dtype")
    if isinstance(shape, int):
        shape = (shape,)
    device = resolve_device(device)
    rdt = torch.empty(0, dtype=dtype).real.dtype
    theta = torch.rand(tuple(shape), generator=_generator(device, seed),
                       dtype=rdt, device=device) * (2 * np.pi)
    return torch.polar(torch.ones_like(theta), theta).to(dtype)
