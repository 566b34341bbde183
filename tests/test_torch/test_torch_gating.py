"""quimb_torch's ``tensor/gating.py`` against quimb_tpu's, on the CPU in
complex128.

Both packages gate the same MPS (numpy arrays from
``np.random.default_rng(seed)``, the same tensor ids) with the same gate in
every ``contract`` mode, and the gated networks are contracted to their
outer indices. Tolerances, relative in the Frobenius norm: 1e-12 where no
bond is truncated (the modes reproduce the exact gated state to round-off);
1e-10 where a split truncates, whose factors two LAPACK calls reproduce to
round-off times the inverse spectral gap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quimb_tpu.tensor as jtn
import quimb_torch.tensor as ttn
from quimb_tpu.tensor import gating as jg
from quimb_torch.tensor import gating as tg

RTOL = 1e-12
SPLIT_TOL = 1e-10
CZ = np.diag([1.0, 1, 1, -1]).astype(complex)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().numpy()
    return np.asarray(x)


def _rand(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _unitary(rng, d):
    return np.linalg.qr(_rand(rng, (d, d)))[0]


def _mps(pkg, L=4, chi=3, seed=0):
    """An open MPS on sites p0..p{L-1}, tensor ids t0..t{L-1}."""
    rng = np.random.default_rng(seed)
    tn = pkg.TensorNetwork([])
    for i in range(L):
        inds = ((f"k{i}",) if i else ()) + (f"p{i}",) + (
            (f"k{i + 1}",) if i < L - 1 else ())
        shape = [chi if ix.startswith("k") else 2 for ix in inds]
        a = _rand(rng, shape)
        data = torch.as_tensor(a) if pkg is ttn else a
        tn.add_tensor(pkg.Tensor(data, inds=inds, tags={f"I{i}"}),
                      tid=f"t{i}", virtual=True)
    return tn


def _dense(tn):
    outer = tuple(sorted(tn.outer_inds()))
    return _np(tn.contract(..., output_inds=outer,
                           preserve_tensor=True).transpose(*outer).data)


def _assert_close(t, j, rtol=RTOL):
    t, j = _dense(t), _dense(j)
    assert t.shape == j.shape
    assert np.linalg.norm(t - j) <= rtol * np.linalg.norm(j)


GATES = {
    "one_site": (lambda rng: _unitary(rng, 2), ("p1",)),
    "cz_rank2": (lambda rng: CZ, ("p1", "p2")),
    "random_rank4": (lambda rng: _unitary(rng, 4), ("p1", "p2")),
    "far_pair": (lambda rng: _unitary(rng, 4), ("p0", "p3")),
    "three_site": (lambda rng: _unitary(rng, 8), ("p0", "p1", "p2")),
}
MODES = [False, True, "split", "reduce-split", "swap+split", "split-gate",
         "auto-split-gate"]


# the split modes take exactly two indices
CASES = [(mode, gate) for mode in MODES for gate in sorted(GATES)
         if len(GATES[gate][1]) == 2
         or mode not in ("split", "reduce-split", "swap+split")]


@pytest.mark.parametrize("mode,gate", CASES,
                         ids=[f"{m}-{g}" for m, g in CASES])
def test_gate_inds_every_mode_matches(mode, gate):
    make, inds = GATES[gate]
    G = make(np.random.default_rng(7))
    t = _mps(ttn).gate_inds(G, inds, contract=mode, tags="G")
    j = _mps(jtn).gate_inds(G, inds, contract=mode, tags="G")
    # the same structure: auto-split-gate makes the same choice
    assert t.num_tensors == j.num_tensors
    assert t.num_indices == j.num_indices
    assert sorted(map(str, t.tags)) == sorted(map(str, j.tags))
    _assert_close(t, j)
    # and the gated state is G applied to the dense state
    dense = _dense(_mps(ttn))
    outer = tuple(sorted(_mps(ttn).outer_inds()))
    axes = [outer.index(ix) for ix in inds]
    n = len(inds)
    G4 = G.reshape((2,) * (2 * n))
    want = np.moveaxis(np.tensordot(G4, dense,
                                    axes=(list(range(n, 2 * n)), axes)),
                       list(range(n)), axes)
    got = _dense(t)
    assert np.linalg.norm(got - want) <= RTOL * np.linalg.norm(want)


def test_auto_split_gate_choice():
    """CZ (operator-Schmidt rank 2) is split into two rank-3 tensors; a
    random two-site unitary (rank 4) stays one lazy gate tensor."""
    for G, extra in ((CZ, 2), (_unitary(np.random.default_rng(1), 4), 1)):
        for pkg in (ttn, jtn):
            tn = _mps(pkg)
            n0 = tn.num_tensors
            tn.gate_inds_(G, ("p1", "p2"), contract="auto-split-gate")
            assert tn.num_tensors == n0 + extra


@pytest.mark.parametrize("mode", ["split", "reduce-split"])
def test_truncating_split_modes_match(mode):
    G = _unitary(np.random.default_rng(3), 4)
    opts = dict(contract=mode, max_bond=2, cutoff=0.0)
    t = _mps(ttn, chi=4).gate_inds(G, ("p1", "p2"), **opts)
    j = _mps(jtn, chi=4).gate_inds(G, ("p1", "p2"), **opts)
    assert t.bond_size("I1", "I2") == j.bond_size("I1", "I2") == 2
    _assert_close(t, j, SPLIT_TOL)


@pytest.mark.parametrize("host", [True, False], ids=["numpy", "torch"])
def test_gate_split_gate_matches(host):
    G = (CZ + 0.5 * np.kron(np.eye(2), np.diag([1, -1]))).reshape(
        2, 2, 2, 2)
    Gt = G if host else torch.as_tensor(G)
    Gl, Gr, k = tg.gate_split_gate(Gt, 2, (2, 2))
    jl, jr, jk = jg.gate_split_gate(G if host else jnp.asarray(G),
                                    2, (2, 2))
    assert k == jk
    want = np.einsum("abk,cdk->acbd", _np(jl), _np(jr))
    got = np.einsum("abk,cdk->acbd", _np(Gl), _np(Gr))
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL)
    np.testing.assert_allclose(got, G, rtol=0, atol=RTOL)
    assert isinstance(Gl, np.ndarray) == host


def test_gate_sandwich_matches():
    """G on the upper indices and G* on the lower ones of an operator."""
    rng = np.random.default_rng(5)
    A = _rand(rng, (2, 2, 2, 2))
    G = _unitary(rng, 4)
    t = ttn.TensorNetwork([ttn.Tensor(torch.as_tensor(A),
                                      ("u0", "u1", "l0", "l1"))])
    j = jtn.TensorNetwork([jtn.Tensor(A, ("u0", "u1", "l0", "l1"))])
    t = tg.tensor_network_gate_sandwich(t, G, ("u0", "u1"), ("l0", "l1"))
    j = jg.tensor_network_gate_sandwich(j, G, ("u0", "u1"), ("l0", "l1"))
    _assert_close(t, j)


def test_host_gate_stays_on_host_in_the_numpy_context():
    from quimb_torch.ops.contraction import contract_backend

    rng = np.random.default_rng(2)
    with contract_backend("numpy"):
        tn = ttn.TensorNetwork([ttn.Tensor(_rand(rng, (2, 2)),
                                           ("p0", "p1"))])
        tn.gate_inds_(CZ, ("p0", "p1"), contract="auto-split-gate")
    assert all(isinstance(t.data, np.ndarray)
               for t in tn.tensor_map.values())
