"""The plain reference of the open spin-1/2 Heisenberg chain: its MPO, built
here from the spin matrices, and the energy of a matrix product state under
it, in float64 (complex128 for a complex state).

Plain PyTorch only: nothing of the program is imported or called. The state
to judge comes in as a list of ``(l, p, r)`` site arrays, the chain's ends
with size-1 bonds.

The MPO is the finite-state machine of ``H = j sum_i S_i . S_{i+1}`` with
``S_i . S_{i+1} = (S+ S- + S- S+) / 2 + Sz Sz``: state 0 has placed no
operator yet, states 1-3 have placed the first operator of a bond term
(S+, S-, Sz), state 4 has completed the term. A site tensor is
``W[a, b, u, d] = <u| O_ab |d>``, so an environment absorbs the ket's
physical index into ``d`` and the bra's into ``u``.
"""

import torch

BOND = 5


def _spin_half(dtype, device):
    splus = torch.tensor([[0.0, 1.0], [0.0, 0.0]], dtype=dtype,
                         device=device)
    sz = torch.tensor([[0.5, 0.0], [0.0, -0.5]], dtype=dtype, device=device)
    return (torch.eye(2, dtype=dtype, device=device), splus,
            splus.T.contiguous(), sz)


def mpo(config, dtype=torch.float64, device="cpu"):
    """The chain's MPO as ``(wl, wr, u, d)`` tensors, the ends cut to
    ``wl = 1`` (the start state) and ``wr = 1`` (the completed state)."""
    if float(config["S"]) != 0.5:
        raise NotImplementedError("the reference MPO is spin-1/2")
    if config.get("cyclic"):
        raise NotImplementedError("the reference MPO is an open chain")
    j, bz = float(config["j"]), float(config.get("bz", 0.0))
    eye, splus, sminus, sz = _spin_half(dtype, device)
    W = torch.zeros((BOND, BOND, 2, 2), dtype=dtype, device=device)
    W[0, 0] = eye
    W[0, 1], W[0, 2], W[0, 3] = splus, sminus, sz
    W[1, 4], W[2, 4], W[3, 4] = j / 2 * sminus, j / 2 * splus, j * sz
    W[0, 4] = -bz * sz
    W[4, 4] = eye
    L = int(config["L"])
    return [W[:1]] + [W] * (L - 2) + [W[:, 4:]]


def dense_hamiltonian(config, dtype=torch.float64):
    """The chain's Hamiltonian as a dense matrix from Kronecker products,
    for short chains (the tests hold the MPO against it)."""
    L = int(config["L"])
    j, bz = float(config["j"]), float(config.get("bz", 0.0))
    eye, splus, sminus, sz = _spin_half(dtype, "cpu")

    def op_at(ops):
        out = torch.ones((1, 1), dtype=dtype)
        for i in range(L):
            out = torch.kron(out, ops.get(i, eye))
        return out

    H = torch.zeros((2**L, 2**L), dtype=dtype)
    for i in range(L - 1):
        H += j / 2 * op_at({i: splus, i + 1: sminus})
        H += j / 2 * op_at({i: sminus, i + 1: splus})
        H += j * op_at({i: sz, i + 1: sz})
    for i in range(L):
        H -= bz * op_at({i: sz})
    return H


def mpo_to_dense(Ws):
    """The dense operator of an MPO, for short chains."""
    T = Ws[0][0]                      # (wr, u, d)
    n = 1
    for W in Ws[1:]:
        T = torch.einsum("aUD,abud->bUuDd", T, W)
        n *= 2
        T = T.reshape(T.shape[0], 2 * n, 2 * n)
    return T[0]


def energy(arrays, config, device=None):
    """``<psi|H|psi> / <psi|psi>`` of the MPS with site arrays ``arrays``
    (``(l, p, r)``) under the chain's MPO, in float64 or complex128 on
    ``device`` (the arrays' own by default). Both environments are
    rescaled by one factor each site, so long chains neither overflow nor
    underflow."""
    device = device or arrays[0].device
    cdtype = torch.complex128 if any(a.is_complex() for a in arrays) \
        else torch.float64
    Ws = mpo(config, cdtype, device)
    env = torch.ones((1, 1, 1), dtype=cdtype, device=device)
    nrm = torch.ones((1, 1), dtype=cdtype, device=device)
    for A, W in zip(arrays, Ws):
        A = A.to(device=device, dtype=cdtype)
        Ab = A.conj()
        env = torch.einsum("bwk,kdx->bwdx", env, A)
        env = torch.einsum("bwdx,wyud->byux", env, W)
        env = torch.einsum("byux,bua->ayx", env, Ab)
        nrm = torch.einsum("bk,kdx->bdx", nrm, A)
        nrm = torch.einsum("bdx,bda->ax", nrm, Ab)
        scale = torch.linalg.norm(nrm)
        env, nrm = env / scale, nrm / scale
    return float((env.reshape(()) / nrm.reshape(())).real)
