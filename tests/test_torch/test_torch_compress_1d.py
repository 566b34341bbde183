"""The 1D compression methods that were deferred to ROADMAP item 16 (``fit``,
``fit-zipup``, ``src``, ``src-oversample``, ``projector``, ``bidm``, and
``compress_all_1d``) in quimb_torch's ``tensor/tn1d/compress.py``, against
quimb_tpu's on the CPU in float64.

H|psi> of a Heisenberg MPO on a random MPS (quimb_tpu's, carried across) is
compressed from its lazy two-layer network. The deterministic methods give
quimb_tpu's state up to a global phase (1e-9, the splits' round-off times
their spectral gaps). ``src`` draws its sketches from a torch generator
where quimb_tpu draws from JAX's PRNG, so it is held to gauge-free facts:
exact at full rank (1e-10), and under truncation an infidelity within 20
times that of ``dm`` (quimb_tpu's own ratio here is 2.3 at L=6 and 6.7 at
L=8; the port's draw gives 10 and 6.1)."""

import functools

import numpy as np
import pytest
import torch

import quimb_tpu.tensor as jtn
from quimb_torch.convert import from_tpu_mpo, from_tpu_mps
from quimb_torch.tensor.tn1d import compress as tc
from quimb_tpu.tensor.tn1d import compress as jc

L, CHI, MAX_BOND = 6, 4, 5
DETERMINISTIC = ("fit", "fit-zipup", "projector", "bidm", "src-oversample")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def pair():
    j = jtn.MPS_rand_state(L, CHI, seed=34)
    jH = jtn.MPO_ham_heis(L)
    return j, jH, from_tpu_mps(j, device="cpu"), from_tpu_mpo(jH, device="cpu")


def _dense(tn, H):
    out = tn.contract(..., output_inds=[H.upper_ind(i) for i in range(L)])
    data = out.data
    return (data.numpy() if isinstance(data, torch.Tensor)
            else np.asarray(data)).reshape(-1)


def _phase_err(a, b):
    ph = np.vdot(a, b)
    ph = ph / abs(ph)
    return np.linalg.norm(a * ph - b) / np.linalg.norm(b)


def _infidelity(a, exact):
    return 1 - abs(np.vdot(a, exact)) ** 2 / (
        np.vdot(a, a).real * np.vdot(exact, exact).real)


def _compress(pkg_comp, H, psi, method, max_bond=MAX_BOND, cutoff=0.0,
              **kw):
    tn = pkg_comp._lazy_mpo_mps_tn(H, psi)
    return pkg_comp.tensor_network_1d_compress(
        tn, max_bond=max_bond, cutoff=cutoff, method=method,
        site_tags=[psi.site_tag(i) for i in range(L)], **kw)


@functools.lru_cache(maxsize=None)
def reference(method):
    j, jH, _, _ = pair()
    return _dense(_compress(jc, jH, j, method), jH)


def exact():
    _, _, t, tH = pair()
    return tH.to_dense().numpy() @ t.to_dense().numpy().reshape(-1)


@pytest.mark.parametrize("method", DETERMINISTIC)
def test_deterministic_methods_match(method):
    _, _, t, tH = pair()
    out = _compress(tc, tH, t, method)
    assert max(out.ind_size(ix) for ix in out.inner_inds()) <= MAX_BOND
    assert out.num_tensors == L
    assert _phase_err(_dense(out, tH), reference(method)) <= 1e-9


@pytest.mark.parametrize("method", ["fit", "src", "src-oversample",
                                    "projector", "bidm"])
def test_gate_with_mpo_methods(method):
    """``MatrixProductState.gate_with_mpo`` by each method: an MPS of
    bond at most ``max_bond``; the deterministic ones give quimb_tpu's
    state."""
    j, jH, t, tH = pair()
    kw = {"seed": 1} if method.startswith("src") else {}
    out = t.gate_with_mpo(tH, max_bond=MAX_BOND, cutoff=0.0, method=method,
                          **kw)
    assert out.max_bond() <= MAX_BOND and out.L == L
    got = out.to_dense().numpy().reshape(-1)
    if method == "src":
        assert _infidelity(got, exact()) <= 20 * _infidelity(
            reference("dm"), exact())
    else:
        want = np.asarray(j.gate_with_mpo(jH, max_bond=MAX_BOND, cutoff=0.0,
                                          method=method).to_dense())
        assert _phase_err(got, want.reshape(-1)) <= 1e-9


def test_src_exact_at_full_rank_and_seeded():
    _, _, t, tH = pair()
    full = _compress(tc, tH, t, "src", max_bond=2 ** (L // 2), seed=5)
    assert _phase_err(_dense(full, tH), exact()) <= 1e-10
    a = _dense(_compress(tc, tH, t, "src", seed=9), tH)
    b = _dense(_compress(tc, tH, t, "src", seed=9), tH)
    np.testing.assert_array_equal(a, b)
    assert _infidelity(a, exact()) <= 20 * _infidelity(reference("dm"),
                                                       exact())
    cut = _compress(tc, tH, t, "src", seed=9, cutoff=1e-3)
    assert max(cut.ind_size(ix) for ix in cut.inner_inds()) <= MAX_BOND


def test_compress_options():
    """``normalize``, ``sweep_reverse`` and ``inplace`` with the fit
    method, against quimb_tpu's."""
    j, jH, t, tH = pair()
    for kw in ({"normalize": True}, {"sweep_reverse": True}):
        got = _dense(_compress(tc, tH, t, "fit", **kw), tH)
        want = _dense(_compress(jc, jH, j, "fit", **kw), jH)
        assert _phase_err(got, want) <= 1e-9
    tn = tc._lazy_mpo_mps_tn(tH, t)
    out = tc.tensor_network_1d_compress(
        tn, max_bond=MAX_BOND, cutoff=0.0, method="bidm", inplace=True,
        site_tags=[t.site_tag(i) for i in range(L)])
    assert out is tn and tn.num_tensors == L
    assert _phase_err(_dense(tn, tH), reference("bidm")) <= 1e-9
    with pytest.raises(ValueError):
        _compress(tc, tH, t, "bogus")


def test_compress_all_1d_matches():
    """``compress_all_1d`` of a contracted MPS (bond 20) by the 1D
    machinery (the default ``dm``), against quimb_tpu's."""
    j, jH, t, tH = pair()
    jp, tp = jH.apply(j), tH.apply(t)
    got = tp.compress_all_1d(max_bond=MAX_BOND, cutoff=0.0)
    want = jp.compress_all_1d(max_bond=MAX_BOND, cutoff=0.0)
    assert got.max_bond() <= MAX_BOND
    g = got.contract(..., output_inds=[t.site_ind(i) for i in range(L)])
    w = want.contract(..., output_inds=[j.site_ind(i) for i in range(L)])
    assert _phase_err(g.data.numpy().reshape(-1),
                      np.asarray(w.data).reshape(-1)) <= 1e-9
