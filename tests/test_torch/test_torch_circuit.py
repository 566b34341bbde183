"""quimb_torch's ``Circuit`` against quimb_tpu's, on the CPU in complex128.

Both packages get the same gates: the seeded brickwork of
``benchref/circuit53.py`` as OpenQASM 2, or a quimb_tpu circuit of many
gate kinds carried across by ``convert.from_tpu_gates``. Amplitudes,
reduced density matrices, expectations, marginals and dense states agree
to 1e-12 relative (both packages run the same exact contractions, in
different orders). Samples drawn with one seed are identical strings: a
uniform draw lands within round-off of a cumulative probability with a
chance near 1e-12. The 53-qubit ``amp0`` is held to jcmgray/quimb's value
in ``benchref/REFBASE.json`` at 1e-9 relative.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import quimb_tpu.tensor as jtn
import quimb_torch.tensor as ttn
from quimb_tpu.tensor.circuit import core as jcore
from quimb_torch import convert
from quimb_torch.ops.contraction import contract_backend
from quimb_torch.tensor.circuit import core as tcore
from quimb_torch.tensor.tn1d.core import MatrixProductState

RTOL = 1e-12
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _load_qasm_circuit():
    spec = importlib.util.spec_from_file_location(
        "circuit53", os.path.join(REPO, "benchref", "circuit53.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.qasm_circuit


qasm_circuit = _load_qasm_circuit()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().numpy()
    return np.asarray(x)


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) <= rtol * np.linalg.norm(b)


def _brickwork(n, depth, seed=7):
    q = qasm_circuit(n, depth, seed)
    return (ttn.Circuit.from_openqasm2_str(q, device="cpu"),
            jtn.Circuit.from_openqasm2_str(q))


def _mixed(n=6, seed=1):
    """quimb_tpu's circuit of many gate kinds (controls, a raw gate, SU4,
    three-qubit gates), and its port through ``from_tpu_gates``."""
    rng = np.random.default_rng(seed)
    j = jtn.Circuit(n)
    j.h(0)
    j.cx(0, 1)
    j.rx(0.3, 2)
    j.fsim(0.2, 0.1, 1, 2)
    j.t(0)
    j.cz(2, 3)
    j.u3(0.1, 0.2, 0.3, 3)
    j.swap(1, 3)
    j.rzz(0.4, 0, 2)
    j.y_1_2(1)
    j.ccx(0, 1, 2)
    j.iswap(2, 3)
    j.su4(*rng.uniform(0, 2 * np.pi, 15), 3, 4)
    j.apply_gate("RY", 0.7, 5, controls=(4,))
    U = np.linalg.qr(rng.standard_normal((4, 4))
                     + 1j * rng.standard_normal((4, 4)))[0]
    j.apply_gate_raw(U, (5, 0))
    j.apply_gate("X", 4, gate_round=3)
    t = ttn.Circuit.from_gates(convert.from_tpu_gates(j.gates), N=n,
                               device="cpu")
    return t, j


def test_circuit_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the circuit would land on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttn.Circuit(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttn.Circuit.from_openqasm2_str(qasm_circuit(4, 2))


def test_from_tpu_gates_carries_every_field():
    t, j = _mixed()
    assert len(t.gates) == len(j.gates)
    for a, b in zip(t.gates, j.gates):
        assert (a.label, a.params, a.qubits, a.controls, a.round) == \
            (b.label, b.params, b.qubits, b.controls, b.round)
        np.testing.assert_array_equal(a.build_array(), b.build_array())


@pytest.mark.parametrize("n,depth", [(8, 4), (12, 6), (16, 8)])
def test_brickwork_amplitudes_match(n, depth):
    t, j = _brickwork(n, depth)
    rng = np.random.default_rng(n)
    for b in ["0" * n, *("".join(rng.choice(["0", "1"], size=n))
                         for _ in range(2))]:
        at = t.amplitude(b)
        assert isinstance(at, complex)
        assert _close(at, complex(j.amplitude(b)))
    # the host contraction gives the same value
    assert _close(t.amplitude(b, backend="numpy"), at)


def test_mixed_circuit_quantities_match():
    t, j = _mixed()
    dense_t = _np(t.to_dense()).ravel()
    dense_j = np.asarray(j.to_dense()).ravel()
    assert _close(dense_t, dense_j)
    for b in ("000000", "101101", "111111"):
        assert _close(t.amplitude(b), complex(j.amplitude(b)))
    for keep in ((1,), (0, 3), (2, 4, 5)):
        rho = t.partial_trace(keep)
        assert isinstance(rho, torch.Tensor) and rho.device.type == "cpu"
        assert _close(_np(rho), np.asarray(j.partial_trace(keep)))
    Z = np.diag([1.0, -1.0])
    ZZ = np.kron(Z, Z)
    assert _close(t.local_expectation(Z, 2),
                  complex(j.local_expectation(Z, 2)))
    assert _close(t.local_expectation(ZZ, (1, 4)),
                  complex(j.local_expectation(ZZ, (1, 4))))
    for where, fix in (((0, 1), None), ((2,), {0: 1, 5: 0}),
                       ((3, 4, 5), {1: 1})):
        assert _close(t.compute_marginal(where, fix=fix),
                      j.compute_marginal(where, fix=fix))
    assert _close(_np(t.get_uni().to_dense(
        [f"k{q}" for q in range(6)], [f"b{q}" for q in range(6)])),
        np.asarray(j.get_uni().to_dense(
            [f"k{q}" for q in range(6)], [f"b{q}" for q in range(6)])))
    assert abs(t.xeb_ex() - j.xeb_ex()) <= RTOL * abs(j.xeb_ex())


def test_marginal_routes_agree(monkeypatch):
    """The cached expression and the per-sample simplify route give the
    same marginal."""
    t, _ = _brickwork(10, 6)
    fix = {0: 1, 3: 0, 9: 1}
    p_expr = t.compute_marginal((4, 5, 6), fix=fix)
    monkeypatch.setattr(tcore, "_EXPR_FLOPS_LIMIT", 0)
    t.clear_storage()
    p_fix = t.compute_marginal((4, 5, 6), fix=fix)
    assert _close(p_fix, p_expr)
    assert abs(p_expr.sum() - 1.0) <= 1e-12


@pytest.mark.parametrize("route", ["batched", "per_sample"])
def test_samples_equal_quimb_tpu(route, monkeypatch):
    t, j = _brickwork(14, 8)
    if route == "per_sample":
        monkeypatch.setattr(tcore, "_EXPR_FLOPS_LIMIT", 0)
        monkeypatch.setattr(jcore, "_EXPR_FLOPS_LIMIT", 0)
    st = list(t.sample(8, seed=42, group_size=4))
    sj = list(j.sample(8, seed=42, group_size=4))
    assert st == sj
    cache = t._region_expr_cache
    batched = [k for k in list(cache)
               if k[0] == "batch" and cache[k] != "fallback"]
    assert bool(batched) == (route == "batched")


def test_single_sample_and_other_samplers_equal_quimb_tpu():
    t, j = _mixed()
    assert list(t.sample(1, seed=3)) == list(j.sample(1, seed=3))
    assert list(t.sample_chaotic(3, 2, seed=5)) == \
        list(j.sample_chaotic(3, 2, seed=5))
    assert list(t.sample_gate_by_gate(3, group_size=3, seed=6)) == \
        list(j.sample_gate_by_gate(3, group_size=3, seed=6))
    assert t.calc_qubit_ordering() == j.calc_qubit_ordering()


def test_complex64_amplitude():
    """complex64 leaves, contracted in complex64: within 1e-5 of
    complex128 at this size."""
    q = qasm_circuit(12, 6)
    t32 = ttn.Circuit.from_openqasm2_str(q, device="cpu", dtype="complex64")
    t64 = ttn.Circuit.from_openqasm2_str(q, device="cpu")
    assert t32.amplitude_tn().dtype == np.complex64
    a32, a64 = t32.amplitude("0" * 12), t64.amplitude("0" * 12)
    assert abs(a32 - a64) <= 1e-5 * abs(a64)


def test_later_work_names_its_item():
    """Item 18 is done: ``mesh=`` on a one-rank gloo world's mesh gives
    quimb_tpu's amplitude, marginal and samples on its 8-device mesh."""
    import torch.distributed as dist
    from quimb_tpu.parallel import get_mesh as jget_mesh
    from quimb_torch.parallel import get_mesh

    t, j = _brickwork(4, 2)
    jmesh, mesh = jget_mesh(8), get_mesh(device="cpu")
    try:
        amp = t.amplitude("0110", mesh=mesh)
        p = t.compute_marginal((0, 2), mesh=mesh)
        samples = list(t.sample(5, seed=3, mesh=mesh))
    finally:
        dist.destroy_process_group()
    want = complex(np.asarray(j.amplitude("0110", mesh=jmesh)).item())
    assert abs(amp - want) <= 1e-12
    np.testing.assert_allclose(p, np.asarray(j.compute_marginal(
        (0, 2), mesh=jmesh)).reshape(-1), rtol=0, atol=1e-12)
    assert samples == list(j.sample(5, seed=3, mesh=jmesh))
    # CircuitDense is ported: the same gates give quimb_tpu's state
    d = ttn.CircuitDense(4, device="cpu")
    d.apply_gates(t.gates)
    jd = jtn.CircuitDense(4)
    jd.apply_gates(j.gates)
    assert _close(_np(d.psi), np.asarray(jd.psi))


def test_53_qubit_amp0_matches_refbase_and_quimb_tpu():
    with open(os.path.join(REPO, "benchref", "REFBASE.json")) as f:
        ref = complex(*json.load(f)["circuit53"]["amp0"])
    t, j = _brickwork(53, 12)
    at = t.amplitude("0" * 53)
    assert abs(at - ref) <= 1e-9 * abs(ref)
    assert abs(at - complex(j.amplitude("0" * 53))) <= RTOL * abs(ref)


def test_sample_gate_by_gate_tns_repaired():
    """quimb_tpu's ``sample_gate_by_gate_tns`` reads ``_psi`` off the
    dicts of ``get_gate_by_gate_circuits`` and raises; the port returns
    each prefix circuit's state, equal to quimb_tpu's."""
    t, j = _mixed()
    with pytest.raises(AttributeError):
        j.sample_gate_by_gate_tns(group_size=3)
    tns = t.sample_gate_by_gate_tns(group_size=3)
    want = [c["circuit"]._psi
            for c in j.get_gate_by_gate_circuits(group_size=3)]
    assert len(tns) == len(want) > 1
    for a, b in zip(tns, want):
        out = tuple(f"k{q}" for q in range(6))
        with contract_backend("numpy"):
            got = a.contract(..., output_inds=out, preserve_tensor=True)
        ref = b.contract(..., output_inds=out, preserve_tensor=True)
        assert _close(got.data, np.asarray(ref.data))


def _scalar(tn):
    """The sum of a network's entries over its open indices: a value two
    networks share whatever their index names."""
    with contract_backend("numpy"):
        tn = tn.copy()
        tn.apply_to_arrays(_np)
        return complex(np.asarray(tn.contract(..., output_inds=())))


def _state(tn):
    out = tuple(f"k{q}" for q in range(6))
    with contract_backend("numpy"):
        tn = tn.copy()
        tn.apply_to_arrays(_np)
        t = tn.contract(..., output_inds=out, preserve_tensor=True)
    return np.asarray(t.data)


HELPERS = {
    "get_psi": lambda c: _state(c.get_psi()),
    "get_psi_simplified": lambda c: _state(c.get_psi_simplified()),
    "to_dense_tn": lambda c: _state(c.to_dense_tn()),
    "to_dense_rehearse": lambda c: _state(c.to_dense_rehearse()["tn"]),
    "schrodinger_contract": lambda c: _np(c.schrodinger_contract(
        output_inds=tuple(f"k{q}" for q in range(6)),
        preserve_tensor=True).data),
    "get_rdm_lightcone_simplified": lambda c: _scalar(
        c.get_rdm_lightcone_simplified((1, 2))),
    "partial_trace_rehearse": lambda c: _scalar(
        c.partial_trace_rehearse((0, 4))["tn"]),
    "local_expectation_tn": lambda c: _scalar(
        c.local_expectation_tn(np.eye(2), 3)),
    "compute_marginal_rehearse": lambda c: _scalar(
        c.compute_marginal_rehearse((2, 3), fix={0: 1})["tn"]),
    "sample_tns": lambda c: [_scalar(tn) for tn in c.sample_tns(
        group_size=4)],
    "sample_chaotic_tn": lambda c: _scalar(c.sample_chaotic_tn(2)),
    "get_qubit_distances": lambda c: c.get_qubit_distances(),
    "reordered_gates_dfs_clustered": lambda c: [
        (g.label, g.qubits, g.controls)
        for g in c.reordered_gates_dfs_clustered()],
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_circuit_helpers_match(name):
    t, j = _mixed()
    got = HELPERS[name](t)
    if name == "schrodinger_contract":
        # quimb_tpu's passes a linear path where its contraction takes
        # one in single-static-assignment form, and raises
        with pytest.raises(KeyError):
            HELPERS[name](j)
        j = j.to_dense().reshape((2,) * 6)
        assert _close(got, np.asarray(j))
        return
    want = HELPERS[name](j)
    if name in ("get_qubit_distances", "reordered_gates_dfs_clustered"):
        assert got == want
    else:
        assert _close(got, want)


def test_matrix_product_state_matches():
    """The open-chain MPS of ``tn1d/core.py`` against quimb_tpu's: its
    sites, indices, dense state, norm network, structured contraction
    and site reindexing."""
    rng = np.random.default_rng(8)
    L, chi = 5, 3
    arrays = []
    for i in range(L):
        shape = [chi] * (i > 0) + [chi] * (i < L - 1) + [2]
        arrays.append(rng.standard_normal(shape)
                      + 1j * rng.standard_normal(shape))
    t = MatrixProductState([torch.as_tensor(a) for a in arrays])
    j = jtn.MatrixProductState(arrays)
    assert (t.L, t.site_tag(7), t.site_ind(2), t.cyclic) == \
        (j.L, j.site_tag(7), j.site_ind(2), j.cyclic)
    assert t.site_inds == j.site_inds and t.site_tags == j.site_tags
    assert _close(_np(t.to_dense()), np.asarray(j.to_dense()))
    assert _close(_np(t.make_norm().contract(...)),
                  np.asarray(j.make_norm().contract(...)))
    assert _close(_np(t.contract(slice(0, L)).data),
                  np.asarray(j.contract(slice(0, L)).data))
    r = t.reindex_sites("q{}")
    assert r.site_ind(3) == "q3" and "q3" in r.ind_map
    # a cyclic chain: every site has both bonds, the wrap bond closes it
    ring = [rng.standard_normal((chi, chi, 2)) for _ in range(L)]
    tr = MatrixProductState([torch.as_tensor(a) for a in ring], cyclic=True)
    jr = jtn.MatrixProductState(ring, cyclic=True)
    assert tr.cyclic and jr.cyclic
    assert _close(_np(tr.to_dense()), np.asarray(jr.to_dense()))
