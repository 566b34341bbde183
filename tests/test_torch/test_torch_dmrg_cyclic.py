"""quimb_torch's segmented ring DMRG (``tn1d/dmrg_cyclic.py``) against
quimb_tpu's, in float64 on the CPU.

quimb_tpu draws its sketches and its bond-growth noise from
``jax.random`` (``PRNGKey(seed)``, one ``split`` per draw, ``fold_in`` per
site of a growth); the port draws from a torch generator. The tests that
follow quimb_tpu hand the port quimb_tpu's draws: :func:`follow_jax`
replaces the engine's two draw methods by ones that walk quimb_tpu's key
sequence in this process. SVD factors carry a sign per singular vector
that differs between the packages, so the compressed closures are
compared through gauge-free products.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quimb_tpu.tensor as qtn
import quimb_torch
from quimb_torch.convert import from_tpu_mpo, from_tpu_mps
from quimb_tpu.tensor.tn1d import dmrg_cyclic as jc
from quimb_tpu.tensor.tn1d.dmrg import get_default_opts as jopts
from quimb_torch.tensor.tn1d import dmrg_cyclic as tc
from quimb_torch.tensor.tn1d.dmrg import get_default_opts as topts

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the tests run beside others on a shared host, where
    torch's default of a thread per core oversubscribes it (a sweep here
    took 143 s under six test workers against 19 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def follow_jax(eng, seed):
    """Make the port's engine ``eng`` draw quimb_tpu's numbers for
    ``CyclicSweeper(seed=seed)``: its sketches and growth pads."""
    key = [jax.random.PRNGKey(seed)]

    def next_key():
        key[0], k = jax.random.split(key[0])
        return k

    def draw(k, shape):
        return torch.from_numpy(np.array(
            jax.random.normal(k, shape, dtype=jnp.float32)))

    eng._draw_sketch = lambda shape: draw(next_key(), shape)

    def pads(shapes):
        k = next_key()
        return [draw(jax.random.fold_in(k, i), s)
                for i, s in enumerate(shapes)]

    eng._draw_pads = pads
    return eng


@functools.lru_cache(maxsize=None)
def _ring(L, chi, seed=42):
    return (qtn.MPO_ham_heis(L, cyclic=True, dtype="float64"),
            qtn.MPS_rand_state(L, chi, cyclic=True, seed=seed,
                               dtype="float64"))


def _engines(L, chi, seed=1):
    """quimb_tpu's engine and the port's on one ring, the port drawing
    quimb_tpu's numbers."""
    H, psi = _ring(L, chi)
    j = jc.CyclicSweeper(jc.cyclic_mpo_arrays(H), jc.cyclic_mps_arrays(psi),
                         jopts(cyclic=True), seed=seed)
    t = tc.CyclicSweeper(
        tc.cyclic_mpo_arrays(from_tpu_mpo(H, device=CPU)),
        tc.cyclic_mps_arrays(from_tpu_mps(psi, device=CPU)), topts(),
        seed=seed)
    return j, follow_jax(t, seed)


def _exact_ring(H, psi):
    """<psi|H|psi> and <psi|psi> of the port's ring by dense contraction."""
    bra = psi.H
    bra.reindex_({psi.site_ind(i): H.lower_ind(i) for i in range(psi.L)})
    e = complex((bra | H | psi).contract(...)).real
    return e, complex((psi.H | psi).contract(...)).real


def _closure_values(eng, s0, s1, comp, seeds, mod):
    """The ring's <H> and <1> from the closure seeds and the explicit
    sites s0..s1 (``mod`` the engine's module)."""
    lenv, renv0, nlenv, nrenv0 = seeds
    for i in range(s0, s1 + 1):
        A = eng._A[i % eng.L]
        conj = np.conj if mod is jc else torch.conj
        step = jc._env_step_right_b if mod is jc else tc._env_step_right
        lenv = step(lenv, conj(A), eng._W[i % eng.L], A)
        nlenv = mod._nenv_step_right(nlenv, conj(A), A)
    e = float(np.real((lenv * renv0).sum()))
    n = float(np.real((nlenv * nrenv0).sum()))
    if mod is tc:
        # the engine's own reading of the ring's Rayleigh quotient
        q = float(tc._ring_quotient(lenv, renv0, nlenv, nrenv0))
        assert q == pytest.approx(e / n, rel=1e-12)
    return e, n


def _seed_product(left, right):
    """sum_s left[s] (x) right[s]: the closure's low-rank transfer, free
    of the sign of each singular vector."""
    left, right = (np.asarray(x) for x in (left, right))
    return np.einsum("sx,sy->xy", left.reshape(left.shape[0], -1),
                     right.reshape(right.shape[0], -1))


def test_roundtrip_arrays():
    """The uniform arrays equal quimb_tpu's; back to a cyclic MPS they
    keep <psi|psi> (float64 contraction of 8 tensors: 1e-12)."""
    H, psi = _ring(8, 4)
    tH, tpsi = from_tpu_mpo(H, device=CPU), from_tpu_mps(psi, device=CPU)
    for got, want in zip(tc.cyclic_mps_arrays(tpsi),
                         jc.cyclic_mps_arrays(psi)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(tc.cyclic_mpo_arrays(tH), jc.cyclic_mpo_arrays(H)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = tc.cyclic_arrays_to_mps(tc.cyclic_mps_arrays(tpsi), tpsi)
    assert back.cyclic and back.L == 8
    assert _exact_ring(tH, back)[1] == pytest.approx(
        _exact_ring(tH, tpsi)[1], rel=1e-12)


def test_compressed_closure_matches_exact_ring():
    """At full sketch rank the randomized transfer SVD is exact: the
    ring's <H> and <1> through the closures equal the dense values (1e-6,
    the compression tolerance, as quimb_tpu's own test holds). The
    closures' low-rank transfers equal quimb_tpu's to 1e-6 of their
    largest entry: the H closure keeps the values above 1e-6 of the
    largest, and where the cut splits a degenerate pair each SVD keeps its
    own vectors of the pair."""
    j, t = _engines(8, 4)
    H, psi = _ring(8, 4)
    e, n = _exact_ring(from_tpu_mpo(H, device=CPU),
                       from_tpu_mps(psi, device=CPU))
    comp = [5, 6, 7]
    tseeds = t._compress_closures(comp)
    jseeds = j._compress_closures(comp)
    e2, n2 = _closure_values(t, 0, 4, comp, tseeds, tc)
    assert e2 == pytest.approx(e, abs=1e-6)
    assert n2 == pytest.approx(n, abs=1e-6)
    for a, b in ((0, 1), (2, 3)):
        want = _seed_product(jseeds[a], jseeds[b])
        got = _seed_product(tseeds[a], tseeds[b])
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert t.bond_sizes == j.bond_sizes
    # one host read of singular values per sketch
    assert t.host_reads >= 2


def test_pseudo_canonize_preserves_state():
    """The edge gauges are exact (x x^-1): the ring's Rayleigh quotient
    does not move (1e-8, quimb_tpu's bound). The gauged pairs across both
    edges equal quimb_tpu's (the same sketch, SVD and eigh in float64:
    1e-10); the single arrays differ by the sign of each eigenvector."""
    j, t = _engines(8, 4)
    H, psi = _ring(8, 4)
    e, n = _exact_ring(from_tpu_mpo(H, device=CPU),
                       from_tpu_mps(psi, device=CPU))
    comp = [5, 6, 7]
    t._pseudo_canonize(0, 4, comp)
    j._pseudo_canonize(0, 4, comp)
    for a, b in ((7, 0), (4, 5)):
        np.testing.assert_allclose(
            tc._theta_2site(t._A[a], t._A[b]).numpy(),
            np.asarray(jc._theta_2site(j._A[a], j._A[b])), atol=1e-10)
    e2, n2 = _closure_values(t, 0, 4, comp, t._compress_closures(comp), tc)
    assert e2 / n2 == pytest.approx(e / n, abs=1e-8)


def test_segmented_sweep_matches():
    """One right sweep of a 10-site ring in thirds, growing the bond from
    4 to 6 (quimb_tpu's growth noise) with quimb_tpu's sketches. The
    energy agrees to 1e-5: each closure is truncated at 1e-6 of its
    largest value in each package's own SVD basis, and the sweep's
    updates carry that on. The state's norm and its dense Rayleigh
    quotient are within quimb_tpu's own bound of 1e-2 of 1 and of the
    sweep's energy, which each update reads through closures compressed
    before its segment's updates (4e-3 apart here)."""
    j, t = _engines(10, 4)
    for eng in (j, t):
        eng.opts["periodic_segment_size"] = 1 / 3
    kw = dict(max_bond=6, cutoff=1e-10, ncv=8, restarts=2)
    ej = j.sweep("R", **kw)
    et = t.sweep("R", **kw)
    assert t.chi == 6
    assert abs(et - ej) < 1e-5
    H, psi = _ring(10, 4)
    tH = from_tpu_mpo(H, device=CPU)
    e, n = _exact_ring(tH, tc.cyclic_arrays_to_mps(
        t._A, from_tpu_mps(psi, device=CPU)))
    assert n == pytest.approx(1.0, abs=1e-2)
    assert e / n == pytest.approx(et, rel=1e-2)


@pytest.mark.parametrize("L,kw,segmented", [
    (10, {}, False), (60, {}, True), (60, {"cyclic_mode": "obc"}, False),
    (10, {"cyclic_mode": "segmented"}, True), (60, {"bsz": 1}, False),
    (60, {"which": "LA"}, False)])
def test_auto_routing(L, kw, segmented):
    """The ring engine takes a ring of 40 sites or more by default (or
    any ring when asked), for two-site ground-state sweeps; every other
    case runs the ring in its open form, as in quimb_tpu (whose side is
    built where it takes the ring engine: its open form compiles for
    seconds)."""
    t = quimb_torch.DMRG(quimb_torch.MPO_ham_heis(L, cyclic=True,
                                                  device=CPU),
                         bond_dims=4, **{"bsz": 2, **kw})
    assert (t._cyc is not None) == segmented
    if segmented:
        j = qtn.DMRG(qtn.MPO_ham_heis(L, cyclic=True), bond_dims=4,
                     **{"bsz": 2, **kw})
        assert j._cyc is not None
    assert t.ham.cyclic == segmented
    if segmented:
        assert t.state.cyclic and t.state.L == L
        assert t.opts["periodic_segment_size"] == 1 / 2
