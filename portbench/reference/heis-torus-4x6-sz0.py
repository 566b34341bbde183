"""The plain reference of the spin-1/2 Heisenberg antiferromagnet on a
periodic square lattice in the sector of zero magnetisation: the sector
basis, the bond flips and the ground energy by Lanczos, in float64.

Plain PyTorch and NumPy only: nothing of the program is imported or
called. It works on any device: the basis and the matrix are built there.

- The lattice is the Lx x Ly torus, site ``(x, y)`` numbered ``x * Ly +
  y``; each site's bond to ``(x, y + 1)`` and to ``(x + 1, y)``, wrapping
  around, with a pair that two steps name twice (a side of 2) counted once.
- A basis state is the integer of its set bits (a set bit is spin up);
  the sector is every integer below ``2**n`` with ``n / 2`` set bits, in
  ascending order, so a state's rank is its index there
  (``torch.searchsorted``).
- ``H = j sum_<ab> S_a . S_b``: a bond adds ``j / 4`` to the diagonal where
  its two bits agree and ``-j / 4`` where they differ, and there flips both
  bits with the amplitude ``j / 2``.
- The ground energy is the lowest Ritz value of a Lanczos basis built with
  full reorthogonalisation from a fixed start, grown until that value moves
  by less than 1e-14 of itself over five steps.
"""

import warnings

import numpy as np
import scipy.linalg as sla
import torch


def edges(config):
    """The bonds of the Lx x Ly torus as pairs of site numbers."""
    Lx, Ly = (int(v) for v in config["lattice"]["args"])
    if not config["lattice"]["kwargs"].get("cyclic"):
        raise NotImplementedError("the reference lattice is a torus")
    out = set()
    for x in range(Lx):
        for y in range(Ly):
            a = x * Ly + y
            for b in (x * Ly + (y + 1) % Ly, ((x + 1) % Lx) * Ly + y):
                if a != b:
                    out.add((min(a, b), max(a, b)))
    return sorted(out)


def sector_basis(n, k, device="cpu"):
    """Every ``n``-bit integer with ``k`` set bits, ascending, as int64."""
    allv = torch.arange(2**n, dtype=torch.int64, device=device)
    count = torch.zeros_like(allv)
    for i in range(n):
        count += (allv >> i) & 1
    return allv[count == k]


def sector_matrix(config, device="cpu", dtype=torch.float64):
    """The sector Hamiltonian as a CSR matrix on ``device`` and the size of
    its sector."""
    n = int(config["lattice"]["args"][0]) * int(config["lattice"]["args"][1])
    j = float(config["model"]["kwargs"]["j"])
    basis = sector_basis(n, int(config["sector"]), device)
    D = basis.numel()
    diag = torch.zeros(D, dtype=dtype, device=device)
    rows, cols = [], []
    for a, b in edges(config):
        differ = ((basis >> a) ^ (basis >> b)) & 1
        diag += torch.where(differ.bool(), -j / 4, j / 4).to(dtype)
        r = torch.nonzero(differ).reshape(-1)
        flipped = basis[r] ^ ((1 << a) | (1 << b))
        rows.append(r)
        cols.append(torch.searchsorted(basis, flipped))
    ar = torch.arange(D, device=device)
    rows = torch.cat(rows + [ar])
    cols = torch.cat(cols + [ar])
    vals = torch.cat([torch.full((rows.numel() - D,), j / 2, dtype=dtype,
                                 device=device), diag])
    with warnings.catch_warnings():
        # notices of the sparse layouts' state and invariant checks
        warnings.simplefilter("ignore", UserWarning)
        H = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (D, D),
                                    check_invariants=False)
        return H.coalesce().to_sparse_csr(), D


def lanczos_ground_energy(matvec, v0, max_steps=300, tol=1e-14, settle=5):
    """The lowest Ritz value of a Lanczos basis with full
    reorthogonalisation (two passes), grown from ``v0`` until the value
    moves by at most ``tol`` of itself for ``settle`` steps in a row."""
    n = v0.numel()
    V = torch.zeros((max_steps, n), dtype=v0.dtype, device=v0.device)
    V[0] = v0 / torch.linalg.norm(v0)
    alpha, beta = [], []
    prev, calm = None, 0
    for m in range(max_steps):
        w = matvec(V[m])
        alpha.append(float(torch.dot(V[m], w)))
        for _ in range(2):
            w = w - V[:m + 1].T @ (V[:m + 1] @ w)
        b = float(torch.linalg.norm(w))
        lam = float(sla.eigh_tridiagonal(np.array(alpha), np.array(beta),
                                         eigvals_only=True,
                                         select="i", select_range=(0, 0))[0])
        if prev is not None and abs(lam - prev) <= tol * abs(lam):
            calm += 1
            if calm >= settle:
                return lam
        else:
            calm = 0
        prev = lam
        if b < 1e-12 or m + 1 == max_steps:
            return lam
        beta.append(b)
        V[m + 1] = w / b
    return prev


def ground_energy(config, device="cpu", dtype=torch.float64):
    """The sector's ground energy, from a start drawn by a fixed CPU
    generator."""
    H, D = sector_matrix(config, device, dtype)
    gen = torch.Generator().manual_seed(0)
    v0 = torch.randn(D, generator=gen, dtype=dtype).to(device)
    return lanczos_ground_energy(lambda x: H @ x, v0)
