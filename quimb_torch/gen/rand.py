"""Random arrays, states and operators with controllable seeding: a port of
quimb_tpu's ``gen/rand.py`` (``randn``, ``seed_rand``, ``get_rand_fill_fn``,
``rand_phase``, the random kets, unitaries, density operators, hermitian
and positive matrices, isometries, product states and MPS).

quimb_tpu draws from JAX's PRNG, which torch cannot reproduce, so the
values differ; the shapes, dtypes, moments and the determinism under one
seed are the same. ``rand_product_state``, the sparse ``rand_herm`` and
the integer draws of ``rand_mix`` and ``rand_seperable`` use
``np.random.default_rng`` as quimb_tpu does and match it exactly. Draws
are made by a ``torch.Generator`` on the device
of the result: a fresh one seeded with ``seed`` when it is given, else
one generator per device that :func:`seed_rand` reseeds.
"""

import threading

import numpy as np
import torch

from ..config import get_default_dtype
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
    dtype = to_torch_dtype(dtype or get_default_dtype())
    device = resolve_device(device)
    return _randn_from(_generator(device, seed), tuple(shape), dtype, scale,
                       loc, dist, device)


def get_rand_fill_fn(dist="normal", loc=0.0, scale=1.0, seed=None,
                     dtype=None, device=None):
    """A stateful ``fill_fn(shape) -> tensor`` on ``device`` (the GPU
    unless given), drawing from one generator seeded ``seed`` (reference
    ``get_rand_fill_fn`` gen/rand.py:322): successive calls draw fresh
    values, and two closures of one seed draw the same sequence."""
    dtype = to_torch_dtype(dtype or get_default_dtype())
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
    dtype = to_torch_dtype(dtype or get_default_dtype())
    if not dtype.is_complex:
        raise ValueError("rand_phase needs a complex dtype")
    if isinstance(shape, int):
        shape = (shape,)
    device = resolve_device(device)
    rdt = torch.empty(0, dtype=dtype).real.dtype
    theta = torch.rand(tuple(shape), generator=_generator(device, seed),
                       dtype=rdt, device=device) * (2 * np.pi)
    return torch.polar(torch.ones_like(theta), theta).to(dtype)


# -- random states and operators of the exact layer ----------------------------


def set_rand_bitgen(bitgen):
    """Kept for quimb_tpu's API: torch's generators take no bit
    generator."""


def rand(*args, **kwargs):
    """A uniform random tensor, in [-0.5, 0.5) as quimb_tpu's."""
    kwargs.setdefault("dist", "uniform")
    return randn(*args, **kwargs)


def rand_rademacher(shape, dtype=None, seed=None, device=None):
    return randn(shape, dtype=dtype or torch.float64, seed=seed,
                 dist="rademacher", device=device)


def rand_matrix(d, scaled=True, dtype=None, seed=None, device=None):
    """A complex gaussian matrix (GinUE), scaled to unit spectral density
    when ``scaled``."""
    m = randn((d, d), dtype=dtype, seed=seed, device=device)
    return m / (2 * np.sqrt(d)) if scaled else m


def rand_herm(d, sparse=False, density=0.01, dtype=None, seed=None,
              device=None):
    """A random hermitian matrix; with ``sparse`` a host scipy CSR matrix
    of about ``density`` filling, drawn from ``np.random.default_rng(seed)``
    as quimb_tpu draws it."""
    if sparse:
        import scipy.sparse as sp

        from ..ops.backend import numpy_dtype

        rng = np.random.default_rng(seed)
        nnz = max(1, int(density * d * d / 2))
        rows = rng.integers(0, d, nnz)
        cols = rng.integers(0, d, nnz)
        vals = rng.standard_normal(nnz) + 1j * rng.standard_normal(nnz)
        m = sp.coo_matrix((vals, (rows, cols)), shape=(d, d)).tocsr()
        m = (m + m.getH()) / 2
        return m.astype(numpy_dtype(to_torch_dtype(dtype or get_default_dtype())))
    m = rand_matrix(d, dtype=dtype, seed=seed, device=device)
    return (m + m.conj().T) / 2


def rand_pos(d, dtype=None, seed=None, device=None):
    """A random positive-semidefinite matrix."""
    m = rand_matrix(d, scaled=False, dtype=dtype, seed=seed, device=device)
    return (m @ m.conj().T) / (4 * d)


def rand_rho(d, dtype=None, seed=None, device=None):
    """A random density operator (trace 1)."""
    rho = rand_pos(d, dtype=dtype, seed=seed, device=device)
    return rho / torch.trace(rho)


def rand_uni(d, dtype=None, seed=None, device=None):
    """A Haar-random unitary: the QR of a gaussian matrix, its R's diagonal
    made positive."""
    from ..ops.decomp import isometrize_qr

    return isometrize_qr(rand_matrix(d, scaled=False, dtype=dtype,
                                     seed=seed, device=device))


def rand_ket(d, dtype=None, seed=None, device=None):
    """A random normalised ket (d, 1)."""
    psi = randn((d, 1), dtype=dtype, seed=seed, device=device)
    return psi / torch.linalg.norm(psi)


def rand_haar_state(d, dtype=None, seed=None, device=None):
    return rand_ket(d, dtype=dtype, seed=seed, device=device)


def gen_rand_haar_states(d, reps, dtype=None, device=None):
    for _ in range(reps):
        yield rand_haar_state(d, dtype=dtype, device=device)


def rand_mix(d, tr_d_min=None, tr_d_max=None, mode="rand", dtype=None,
             seed=None, device=None):
    """A random mixed state: a random pure state of the system and an
    environment of dimension drawn from ``np.random.default_rng(seed)``
    in [tr_d_min, tr_d_max], the environment traced out."""
    tr_d_min = d if tr_d_min is None else tr_d_min
    tr_d_max = d if tr_d_max is None else tr_d_max
    tr_d = int(np.random.default_rng(seed).integers(tr_d_min, tr_d_max + 1))
    psi = rand_ket(d * tr_d, dtype=dtype, seed=seed,
                   device=device).reshape(d, tr_d)
    return psi @ psi.conj().T


def rand_product_state(n, qtype=None, dtype=None, seed=None, device=None):
    """A random product state of ``n`` qubits, each drawn uniformly on the
    Bloch sphere from ``np.random.default_rng(seed)`` as quimb_tpu draws
    it."""
    rng = np.random.default_rng(seed)
    vec = np.array([1.0])
    for _ in range(n):
        phi = rng.uniform(0, 2 * np.pi)
        theta = np.arccos(rng.uniform(-1, 1))
        vec = np.kron(vec, np.array([np.cos(theta / 2),
                                     np.exp(1j * phi) * np.sin(theta / 2)]))
    return torch.as_tensor(vec.reshape(-1, 1),
                           dtype=to_torch_dtype(dtype or get_default_dtype()),
                           device=resolve_device(device))


def rand_matrix_product_state(n, bond_dim, phys_dim=2, dtype=None,
                              seed=None, normalize=True, device=None):
    """A random MPS (``MPS_rand_state``) as a dense ket."""
    from ..tensor.tn1d.builders import MPS_rand_state

    psi = MPS_rand_state(n, bond_dim, phys_dim=phys_dim, dtype=dtype,
                         seed=seed, normalize=normalize, device=device)
    return psi.to_dense().reshape(-1, 1)


rand_mps = rand_matrix_product_state


def rand_seperable(dims, num_mix=10, dtype=None, seed=None, device=None):
    """A random separable mixed state on subsystems of sizes ``dims``: the
    weights and the seeds of its factors from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    total = None
    for _ in range(num_mix):
        p = rng.random()
        term = None
        for d in dims:
            rho = rand_rho(d, dtype=dtype, seed=int(rng.integers(2**31)),
                           device=device)
            term = rho if term is None else torch.kron(term, rho)
        total = p * term if total is None else total + p * term
    return total / torch.trace(total)


def rand_iso(m, n, dtype=None, seed=None, device=None):
    """A random isometry of shape (m, n)."""
    from ..ops.decomp import isometrize_qr

    return isometrize_qr(randn((m, n), dtype=dtype, seed=seed,
                               device=device))


def rand_mera(n, *args, **kwargs):
    from ..tensor.tn1d.mera import MERA

    return MERA.rand(n, *args, **kwargs)


__all__ = [
    "seed_rand", "randn", "get_rand_fill_fn", "rand_phase",
    "set_rand_bitgen", "rand", "rand_rademacher", "rand_matrix",
    "rand_herm", "rand_pos", "rand_rho", "rand_uni", "rand_ket",
    "rand_haar_state", "gen_rand_haar_states", "rand_mix",
    "rand_product_state", "rand_matrix_product_state", "rand_mps",
    "rand_seperable", "rand_iso", "rand_mera",
]
