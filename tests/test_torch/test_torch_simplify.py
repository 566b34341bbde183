"""quimb_torch's ``tensor/simplify.py`` against quimb_tpu's, on the CPU in
complex128.

The networks are circuit networks (quimb_tpu's ``Circuit`` of a seeded
random circuit: its state, an amplitude network, a marginal norm network)
and small hand-built ones (a low-rank tensor, a low-rank pair, a triangle,
a hyper index). Each is carried to the port tensor by tensor, with the
same tensor ids, so both packages walk it in one order. Every rewrite
keeps the network's contracted value (1e-12 relative in the Frobenius
norm against the value before it) and leaves the same number of tensors
and indices as quimb_tpu's, with a value within 1e-12 of quimb_tpu's. New
tensor ids and index names come from one counter in both packages, since
the rewrites break ties in the order of sets of tensor ids.
"""

import numpy as np
import pytest
import torch

import quimb_tpu.tensor as jtn
import quimb_torch.tensor as ttn
from quimb_tpu.tensor import core as jcore
from quimb_tpu.tensor import simplify as jsimplify
from quimb_torch.ops.contraction import contract_backend
from quimb_torch.tensor import core as tcore
from quimb_torch.tensor import simplify as tsimplify

RTOL = 1e-12


@pytest.fixture
def same_uuids(monkeypatch):
    """Both packages name new tensors and indices from one counter, reset
    before each package's run to a value past every name the networks
    were built with: the rewrites iterate sets of tensor ids, so equal
    names give both packages one order."""
    state = {"n": 0}

    def reset():
        state["n"] = 10**6

    def uuid(base=""):
        state["n"] += 1
        return f"{base}_u{state['n']}"

    for mod in (jcore, jsimplify, tcore, tsimplify):
        monkeypatch.setattr(mod, "rand_uuid", uuid)
    return reset


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().numpy()
    return np.asarray(x)


def _value(tn, output_inds):
    out = tuple(output_inds)
    if not out:
        return np.asarray(_np(tn.contract(..., output_inds=())))
    t = tn.contract(..., output_inds=out, preserve_tensor=True)
    return _np(t.transpose(*out).data)


def _close(a, b, rtol=RTOL):
    return np.linalg.norm(a - b) <= rtol * np.linalg.norm(b)


def _to_port(jnet):
    """quimb_tpu's network -> the port's (CPU torch tensors), with the
    same tensor ids, indices, tags and order."""
    tn = ttn.TensorNetwork([])
    for tid, t in jnet.tensor_map.items():
        tn.add_tensor(ttn.Tensor(torch.as_tensor(np.array(t.data)),
                                 inds=t.inds, tags=tuple(t.tags)),
                      tid=tid, virtual=True)
    return tn


def _circuit(n=6, depth=3, seed=3):
    """quimb_tpu's lazy circuit of a seeded random circuit with diagonal
    (CZ, RZ), anti-diagonal (X) and generic (U3, CX, FSIM) gates."""
    rng = np.random.default_rng(seed)
    circ = jtn.Circuit(n)
    for layer in range(depth):
        for q in range(n):
            kind = rng.integers(3)
            if kind == 0:
                circ.apply_gate("U3", *rng.uniform(0, 2 * np.pi, 3), q)
            elif kind == 1:
                circ.apply_gate("X", q)
            else:
                circ.apply_gate("RZ", rng.uniform(0, 2 * np.pi), q)
        for q in range(layer % 2, n - 1, 2):
            gate = ("CZ", "CX", "FSIM")[(q + layer) % 3]
            if gate == "FSIM":
                circ.apply_gate("FSIM", *rng.uniform(0, 2 * np.pi, 2), q,
                                q + 1)
            else:
                circ.apply_gate(gate, q, q + 1)
    return circ


def _amplitude_tn():
    circ = _circuit()
    psi = circ._psi.copy()
    psi.isel_({psi.site_ind(q): q % 2 for q in range(circ.N)})
    return psi, ()


def _state_tn():
    circ = _circuit(n=6)
    psi = circ._psi.copy()
    return psi, tuple(psi.site_ind(q) for q in range(circ.N))


def _norm_tn():
    """The lightcone norm network of qubits (2, 3), bra = ket on them:
    the diagonal of their reduced density matrix."""
    circ = _circuit()
    psi = circ.get_psi_reverse_lightcone((2, 3))
    bra = psi.H
    bra.mangle_inner_()
    return psi & bra, ("k2", "k3")


def _hand_tn():
    """A low-rank tensor, a low-rank pair, a triangle and a hyper index."""
    rng = np.random.default_rng(11)

    def c(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    low = np.einsum("a,bc->abc", c(3), c(3, 4))
    u, v = c(5, 2), c(2, 6)
    ts = [
        jtn.Tensor(low, ("a", "b", "c")),
        jtn.Tensor(c(4, 5), ("c", "d")),
        jtn.Tensor((u @ v)[:, :3], ("d", "e")),
        jtn.Tensor((u @ v)[:, 3:].T, ("f", "g")),
        jtn.Tensor(c(3, 3), ("e", "h")),
        jtn.Tensor(c(3, 3, 2), ("h", "i", "x")),
        jtn.Tensor(c(3, 3), ("i", "e2")),
        jtn.Tensor(c(2, 2), ("x", "y")),
        jtn.Tensor(c(2, 2), ("x", "z")),
    ]
    tn = jtn.TensorNetwork([])
    for i, t in enumerate(ts):
        tn.add_tensor(t, tid=f"t{i}", virtual=True)
    return tn, tuple(sorted(tn.outer_inds()))


NETWORKS = {
    "amplitude": _amplitude_tn,
    "state": _state_tn,
    "norm": _norm_tn,
    "hand": _hand_tn,
}
REWRITES = {
    "rank_simplify": dict(),
    "diagonal_reduce": dict(atol=1e-12),
    "antidiag_gauge": dict(atol=1e-12),
    "column_reduce": dict(atol=1e-12),
    "split_simplify": dict(atol=1e-12),
    "pair_simplify": dict(cutoff=1e-12),
    "loop_simplify": dict(),
    "hyperinds_resolve": dict(),
}
_TAKES_OUTPUT = ("rank_simplify", "diagonal_reduce", "antidiag_gauge",
                 "column_reduce", "pair_simplify", "hyperinds_resolve")


def _prepare(net, name):
    """Both packages' copies; hyperinds_resolve gets a network with hyper
    indices (after diagonal_reduce), the others the network itself."""
    jnet, out = NETWORKS[net]()
    if name == "hyperinds_resolve":
        jnet = jnet.diagonal_reduce(output_inds=out)
    return _to_port(jnet), jnet, out


@pytest.mark.parametrize("net", sorted(NETWORKS))
@pytest.mark.parametrize("name", sorted(REWRITES))
def test_rewrite_keeps_value_and_matches(name, net, same_uuids):
    t, j, out = _prepare(net, name)
    before = _value(t, out)
    opts = dict(REWRITES[name])
    if name in _TAKES_OUTPUT:
        opts["output_inds"] = out
    same_uuids()
    ts = getattr(t, name)(**opts)
    same_uuids()
    js = getattr(j, name)(**opts)
    assert (ts.num_tensors, ts.num_indices) == (js.num_tensors,
                                                js.num_indices)
    after = _value(ts, out)
    assert _close(after, before)
    assert _close(after, _value(js, out))
    # the in-place form gives the same network, from the same names
    same_uuids()
    getattr(t, name + "_")(**opts)
    assert (t.num_tensors, t.num_indices) == (ts.num_tensors,
                                              ts.num_indices)


@pytest.mark.parametrize("net", ["amplitude", "norm", "state"])
@pytest.mark.parametrize("seq", ["ADCR", "ADCRS"])
def test_full_simplify_matches(seq, net, same_uuids):
    t, j, out = _prepare(net, "full_simplify")
    before = _value(t, out)
    same_uuids()
    ts = t.full_simplify(seq=seq, output_inds=out)
    same_uuids()
    js = j.full_simplify(seq=seq, output_inds=out)
    assert (ts.num_tensors, ts.num_indices) == (js.num_tensors,
                                                js.num_indices)
    assert ts.num_tensors < t.num_tensors
    after = _value(ts, out)
    assert _close(after, before)
    assert _close(after, _value(js, out))
    # torch leaves go back to their device, in their dtype
    assert all(isinstance(x.data, torch.Tensor) and x.data.device.type
               == "cpu" and x.data.dtype == torch.complex128
               for x in ts.tensor_map.values())


def test_full_simplify_keeps_host_leaves_on_the_host():
    jnet, out = _amplitude_tn()
    with contract_backend("numpy"):
        tn = ttn.TensorNetwork([])
        for tid, x in jnet.tensor_map.items():
            tn.add_tensor(ttn.Tensor(np.array(x.data), x.inds), tid=tid)
        tn.full_simplify_(seq="ADCR", output_inds=out)
    assert all(isinstance(x.data, np.ndarray)
               for x in tn.tensor_map.values())
    assert _close(_value(tn, out), _value(jnet, out))


def test_full_simplify_equalize_norms_matches(same_uuids):
    t, j, out = _prepare("norm", "full_simplify")
    same_uuids()
    ts = t.full_simplify(seq="ADCRS", output_inds=out, equalize_norms=True)
    same_uuids()
    js = j.full_simplify(seq="ADCRS", output_inds=out, equalize_norms=True)
    assert abs(ts.exponent - js.exponent) <= 1e-12 * max(1, abs(js.exponent))
    assert _close(_value(ts, out), _value(js, out))
