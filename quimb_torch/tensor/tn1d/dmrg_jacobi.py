"""Uniform padded stacks of an open chain, and the batched pieces of a
local solve that the segment-parallel engine shares.

Port of the parts of ``quimb_tpu/tensor/tn1d/dmrg_jacobi.py`` that
:mod:`quimb_torch.tensor.tn1d.dmrg_parallel` imports: the conversions
between site-tensor lists and zero-padded stacks, the batched two-site
matvec and the batched tridiagonal eigenvector. The converters take and
return MPS / MPO objects, as quimb_tpu's do, and stay on the objects'
device (quimb_tpu's go through host numpy). The whitened
brickwork engine of that module (``JacobiDMRG``) is not ported here.
"""

import torch

from ...ops import decomp
from .core import _arrays_to_mps, _mpo_uniform_arrays, _mps_uniform_arrays


def mps_to_stack(psi, chi):
    """Uniform (L, chi, d, chi) stack of the open MPS ``psi``'s site
    tensors, zero-padded on both bonds, on its device."""
    state = _mps_uniform_arrays(psi)
    L, d = len(state), state[0].shape[1]
    A0 = state[0]
    dtype = A0.dtype
    for A in state:
        dtype = torch.promote_types(dtype, A.dtype)
    Ms = torch.zeros((L, chi, d, chi), dtype=dtype, device=A0.device)
    for j, A in enumerate(state):
        kl, _, kr = A.shape
        if kl > chi or kr > chi:
            raise ValueError(
                f"bond dimension {max(kl, kr)} exceeds stack chi={chi}"
            )
        Ms[j, :kl, :, :kr] = A
    return Ms


def _stack_to_arrays(Ms, tol=0.0):
    """Site tensors ``(l, p, r)`` of the padded stack ``Ms``, with each
    inner bond cut to its count of live columns: those with an entry
    above ``tol`` on either side of the bond (quimb_tpu's rule, at least
    one). The chain ends get size-1 bonds."""
    L = Ms.shape[0]
    wr = Ms[:-1].abs().amax(dim=(1, 2))         # right bond of site j - 1
    wl = Ms[1:].abs().amax(dim=(2, 3))          # left bond of site j
    alive = ((wr > tol) | (wl > tol)).sum(dim=-1).tolist()
    ranks = [1] + [max(int(r), 1) for r in alive] + [1]
    return [Ms[j, :ranks[j], :, :ranks[j + 1]].clone() for j in range(L)]


def stack_to_mps(Ms, like, tol=0.0):
    """The padded stack ``Ms`` as an MPS with the index and tag ids of
    ``like``, each bond cut to its live columns (:func:`_stack_to_arrays`)."""
    return _arrays_to_mps(_stack_to_arrays(Ms, tol), like=like)


def mpo_to_padded_stack(ham, w=None):
    """Uniform (L, w, w, d, d) stack of the open MPO ``ham``'s tensors;
    the chain ends' size-1 bonds sit at channel 0, to pair with one-hot
    channel-0 boundary environments."""
    ham_arrays = _mpo_uniform_arrays(ham)
    if w is None:
        w = max(max(W.shape[0], W.shape[1]) for W in ham_arrays)
    W0 = ham_arrays[0]
    d = W0.shape[-1]
    Ws = torch.zeros((len(ham_arrays), w, w, d, d), dtype=W0.dtype,
                     device=W0.device)
    for j, W in enumerate(ham_arrays):
        Ws[j, :W.shape[0], :W.shape[1]] = W
    return Ws


def _batched_matvec(LW1, W2R, th):
    """Batched 2-site Heff matvec: th (nb, k, d, d, r) via LW1
    (nb, a, x, u, p, k) and W2R (nb, x, v, q, b, r)."""
    t = torch.einsum("nkpqr,naxupk->nauxqr", th, LW1)
    return torch.einsum("nauxqr,nxvqbr->nauvb", t, W2R)


def _batched_tridiag_eigvec(alpha, beta):
    """Smallest eigenpair (value, coefficients) of batched (ncv)
    symmetric tridiagonals (alpha, beta)."""
    ncv = alpha.shape[-1]
    eye = torch.eye(ncv, dtype=alpha.dtype, device=alpha.device)
    T = alpha[..., :, None] * eye
    off = torch.diag_embed(beta[..., :ncv - 1], offset=1)
    T = T + off + off.transpose(-2, -1)
    wv, S = decomp.safe_eigh(T)
    return wv[..., 0], S[..., :, 0]
