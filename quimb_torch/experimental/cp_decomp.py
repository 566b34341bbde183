"""CANDECOMP/PARAFAC decomposition of tensors and a network simplification
built on it.

Port of quimb_tpu's ``experimental/cp_decomp.py`` (reference
``quimb/experimental/misc/cp_decomp.py``). A CP decomposition writes
``T[i1..in] = sum_r A1[i1,r]...An[in,r]``: in network form, ``n`` factor
matrices sharing one hyper index. It runs classic CP-ALS (each mode a
least-squares solve against the Khatri-Rao product of the others) on the
tensor's device, from start factors drawn by ``np.random.default_rng(seed)``,
so both packages start from the same factors. As in quimb_tpu, each sweep
reads its reconstruction error to the host.
"""

import numpy as np
import torch

from ..ops.backend import numpy_dtype, to_device
from ..tensor.core import Tensor, TensorNetwork, rand_uuid

__all__ = ["cp_decompose", "cp_simplify"]


def _cp_als_arrays(X, rank, steps, tol, seed):
    """ALS on the dense tensor ``X``; returns its factor matrices and the
    last relative reconstruction error."""
    ndim = X.ndim
    rng = np.random.default_rng(seed)
    draw_dtype = np.float64 if X.dtype.is_complex else numpy_dtype(X.dtype)
    factors = [
        to_device(rng.standard_normal((X.shape[k], rank)).astype(draw_dtype),
                  device=X.device, dtype=X.dtype)
        for k in range(ndim)
    ]
    letters = "abcdefghijklmnop"
    prev_err = None
    err = None
    nrmX = torch.linalg.norm(X.reshape(-1))
    eye = torch.eye(rank, dtype=X.dtype, device=X.device)
    for _ in range(steps):
        for k in range(ndim):
            # gram: hadamard product of A_j^H A_j over j != k
            V = None
            for j in range(ndim):
                if j == k:
                    continue
                G = factors[j].conj().T @ factors[j]
                V = G if V is None else V * G
            # rhs: contract X with all other factors -> (d_k, R)
            eq_in = letters[:ndim]
            operands = [X]
            for j in range(ndim):
                if j == k:
                    continue
                eq_in += f",{letters[j]}z"
                operands.append(factors[j].conj())
            M = torch.einsum(f"{eq_in}->{letters[k]}z", *operands)
            factors[k] = torch.linalg.solve(V.T + 1e-12 * eye, M.T).T
        # convergence check on the reconstruction error
        eq = ",".join(f"{letters[j]}z" for j in range(ndim))
        R = torch.einsum(f"{eq}->{letters[:ndim]}", *factors)
        err = float(torch.linalg.norm((R - X).reshape(-1)) / (nrmX + 1e-300))
        if prev_err is not None and abs(prev_err - err) < tol:
            break
        prev_err = err
    return factors, err


def cp_decompose(t, rank, bond_ind=None, steps=100, tol=1e-12, seed=0):
    """CP-decompose Tensor ``t`` into a network of ``t.ndim`` factor
    matrices sharing the hyper index ``bond_ind``.

    Returns
    -------
    TensorNetwork
    """
    if bond_ind is None:
        bond_ind = rand_uuid()
    factors, _ = _cp_als_arrays(t.data, rank, steps, tol, seed)
    return TensorNetwork(
        [Tensor(A, inds=(ix, bond_ind), tags=t.tags)
         for A, ix in zip(factors, t.inds)],
        virtual=True, check_collisions=False,
    )


def cp_simplify(tn, atol=1e-12, inplace=False, **cp_opts):
    """Replace any tensor whose dimensions are all equal by its CP
    decomposition at that rank, wherever it is exact to ``atol``: dense
    cores become hyper-index stars, cheaper to contract."""
    new = tn if inplace else tn.copy()
    for tid in tuple(new.tensor_map):
        t = new.tensor_map[tid]
        if t.ndim < 3:
            continue
        dims = set(t.shape)
        if len(dims) != 1:
            continue
        (rank,) = dims
        tcp = cp_decompose(t, rank, **cp_opts)
        recon = tcp.contract(..., output_inds=t.inds, preserve_tensor=True)
        if float(torch.max(torch.abs(recon.data - t.data))) > atol:
            continue
        new._pop_tensor(tid)
        for ft in tcp:
            new.add_tensor(ft.copy())
    return new
