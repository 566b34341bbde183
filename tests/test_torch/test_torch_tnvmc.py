"""quimb_torch's ``experimental/tnvmc.py`` against quimb_tpu's, on the CPU.

From the same parameters (a 3 x 2 PEPS in float64 and complex128 and an
L=6 MPS, all from ``np.random.default_rng``) and the same injected
configurations: the batched amplitudes, the local energies, the
per-configuration log-derivatives ``O`` (quimb_tpu's convention for complex
parameters) and one ``step`` with each conditioner (``sr``, ``minsr``,
``sgd``), all within 1e-10 relative. For complex parameters the port's
step is quimb_tpu's formula with ``O`` conjugated (quimb_tpu's own is no
descent there), computed in numpy from quimb_tpu's ``O`` and local
energies; a test of its own shows it lowers a complex start's energy
where quimb_tpu's update lowers it less. The direct samplers (dense,
cluster, BP) draw from numpy's ``default_rng`` in both packages and give
the same strings from one seed; the Metropolis chains draw from a torch
generator, so their estimates are held to the exact energy on a 2 x 2
PEPS within 5 standard errors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quimb_tpu.tensor as jtn
from quimb_tpu.experimental import tnvmc as jv
from quimb_tpu.operator import heisenberg_from_edges as jheis
from quimb_torch import convert
from quimb_torch.experimental import tnvmc as tv
from quimb_torch.operator import heisenberg_from_edges as theis

CPU = "cpu"
TOL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().numpy()
    return np.asarray(x)


def _rel(got, want):
    got, want = _np(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _grid_edges(Lx, Ly):
    edges = []
    for i in range(Lx):
        for j in range(Ly):
            if i + 1 < Lx:
                edges.append((i * Ly + j, (i + 1) * Ly + j))
            if j + 1 < Ly:
                edges.append((i * Ly + j, i * Ly + j + 1))
    return edges


def _peps_pair(Lx, Ly, D, seed, cplx=False):
    rng = np.random.default_rng(seed)
    arrays = []
    for i in range(Lx):
        row = []
        for j in range(Ly):
            sh = [D] * sum((i < Lx - 1, j < Ly - 1, i > 0, j > 0)) + [2]
            a = rng.standard_normal(sh)
            if cplx:
                a = a + 1j * rng.standard_normal(sh)
            row.append(a / 2)
        arrays.append(row)
    j = jtn.PEPS(arrays, shape="urdlp")
    return j, convert.from_tpu_peps(j, device=CPU), _grid_edges(Lx, Ly)


def _mps_pair(L=6, D=3, seed=4):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(
        [D] * ((i > 0) + (i < L - 1)) + [2]) for i in range(L)]
    j = jtn.MatrixProductState(arrays, shape="lrp")
    return j, convert.from_tpu_mps(j, device=CPU), [(i, i + 1)
                                                    for i in range(L - 1)]


CASES = {
    "peps-real": lambda: _peps_pair(3, 2, 2, 3),
    "peps-complex": lambda: _peps_pair(3, 2, 2, 5, cplx=True),
    "mps": _mps_pair,
}


def _vmc_pair(case, **opts):
    j, t, edges = CASES[case]()
    vj = jv.TNVMC(j, jheis(edges), **opts)
    vt = tv.TNVMC(t, theis(edges), **opts)
    return vj, vt


@pytest.mark.parametrize("case", sorted(CASES))
def test_amplitudes_energies_and_gradients_match(case):
    vj, vt = _vmc_pair(case, nchains=12)
    configs = np.random.default_rng(7).integers(0, 2, (12, vt.nsites))
    cj = jnp.asarray(configs, dtype=jnp.int32)
    aj = vj._log_amp_batch(vj.params, cj)
    at = vt._log_amp_batch(vt.params, configs)
    assert _rel(at, aj) <= TOL
    assert _rel(vt._local_energies(vt.params, configs),
                vj._local_energies(vj.params, cj)) <= TOL
    Oj = np.asarray(vj._grad_logs(vj.params, cj))
    Ot = vt._grad_logs(vt.params, configs)
    assert Ot.shape == Oj.shape and _rel(Ot, Oj) <= TOL
    # one configuration at a time, and the isel + contract of the network
    psi = vt.psi
    for c, a in zip(configs[:3], _np(at)):
        one = vt._amp_fn(vt.params, torch.as_tensor(c))
        sel = psi.isel({psi.site_ind(s): int(v)
                        for s, v in zip(psi.sites, c)}).contract(...)
        assert complex(one) == pytest.approx(complex(a), rel=1e-12)
        assert complex(sel) == pytest.approx(complex(a), rel=1e-12)


def _conjugate_update(vj, configs, conditioner, lr, damping):
    """The parameters after one step of quimb_tpu's update with ``O``
    conjugated, from quimb_tpu's own ``O`` and local energies, in numpy:
    ``sr`` solves (O^H O / n + damping) delta = 2 O^H (E_loc - E) / n,
    ``minsr`` takes delta = 2 O^H (O O^H / n + damping)^-1 (E_loc - E) / n
    and ``sgd`` delta = 2 O^H (E_loc - E) / n, with O centred."""
    cj = jnp.asarray(configs, dtype=jnp.int32)
    O = np.asarray(vj._grad_logs(vj.params, cj))
    e_loc = np.asarray(vj._local_energies(vj.params, cj))
    n = O.shape[0]
    Om = O - O.mean(axis=0)
    dE = e_loc - np.mean(e_loc.real)
    force = 2 * Om.conj().T @ dE / n
    if conditioner == "sr":
        delta = np.linalg.solve(
            Om.conj().T @ Om / n + damping * np.eye(O.shape[1]), force)
    elif conditioner == "minsr":
        delta = 2 * Om.conj().T @ np.linalg.solve(
            Om @ Om.conj().T / n + damping * np.eye(n), dE) / n
    else:
        delta = force
    return np.concatenate([np.asarray(p).ravel() for p in vj.params]) \
        - lr * delta


@pytest.mark.parametrize("conditioner", ["sr", "minsr", "sgd"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_injected_step_matches(case, conditioner):
    """One step from injected configurations: quimb_tpu's energy, error and
    (real parameters) new parameters; for complex parameters the new
    parameters of quimb_tpu's formula with ``O`` conjugated."""
    vj, vt = _vmc_pair(case, nchains=16, conditioner=conditioner,
                       learning_rate=0.07, sr_damping=1e-2)
    configs = np.random.default_rng(11).integers(0, 2, (16, vt.nsites))
    cplx = case == "peps-complex"
    if cplx:
        want = _conjugate_update(vj, configs, conditioner, 0.07, 1e-2)
    vj._sample_batch = lambda params, n: jnp.asarray(configs, jnp.int32)
    vt._sample_batch = lambda params, n: torch.as_tensor(configs)
    (ej, sj), (et, st) = vj.step(), vt.step()
    assert et == pytest.approx(ej, rel=TOL) and st == pytest.approx(sj,
                                                                    rel=TOL)
    for a, b in zip(vt.params, vj.params):
        assert a.dtype == getattr(torch, str(b.dtype))
        if not cplx:
            assert _rel(a, b) <= TOL
    if cplx:
        got = torch.cat([p.reshape(-1) for p in vt.params])
        assert _rel(got, want) <= TOL
    assert vt.energies == [et] and vt.energy == et
    got = vt.get_state()
    assert all(torch.equal(x.data, p) for x, p in zip(got, vt.params))


def test_direct_samplers_give_quimb_tpus_strings():
    j, t, edges = _peps_pair(2, 2, 2, 8)
    pairs = [(jv.DenseSampler(j, seed=3), tv.DenseSampler(t, seed=3)),
             (jv.ClusterSampler(j, max_distance=1, seed=3),
              tv.ClusterSampler(t, max_distance=1, seed=3)),
             (jv.BPSampler(j, seed=3, max_iterations=40),
              tv.BPSampler(t, seed=3, max_iterations=40))]
    for sj, st in pairs:
        for _ in range(4):
            (cj, oj), (ct, ot) = sj.sample(), st.sample()
            assert list(ct) == list(np.asarray(cj))
            assert ot == pytest.approx(oj, rel=1e-8)
    batch = tv.DenseSampler(t, seed=1).sample_batch(5)
    assert batch.shape == (5, 4) and batch.dtype == torch.int64


def _exact_energy(psi, edges):
    Hd = theis(edges).build_sparse_matrix().toarray()
    v = _np(psi.to_dense()).reshape(-1)
    return float(np.real(v.conj() @ Hd @ v / (v.conj() @ v))), Hd, v


def _projected_energy(Hd, v, keep):
    """The energy of ``v`` projected on the configurations ``keep(c)``."""
    mask = np.array([keep(bin(c).count("1")) for c in range(v.size)])
    vp = np.where(mask, v, 0.0)
    return float(np.real(vp.conj() @ (Hd @ vp) / (vp.conj() @ vp)))


@pytest.mark.parametrize("kind", ["metropolis", "exchange", "hamiltonian",
                                  "dense", "cluster"])
def test_sampler_estimates_match_the_exact_energy(kind):
    """Each sampler's estimate within 5 standard errors of the exact energy
    of the configurations it can reach: all (Metropolis, the direct
    samplers), the half-filled ones (exchange moves from a half-filled
    start) or those of even magnetisation parity (the Heisenberg flip
    masks from a half-filled start). The exchange moves swap neighbours in
    the sites' linear order, as quimb_tpu's, and cannot pass a
    configuration of near-zero weight: this state gives each half-filled
    configuration at least 6 % of the sector's weight, so 16 sweeps mix."""
    j, t, edges = _peps_pair(2, 2, 2, 13)
    e_exact, Hd, v = _exact_energy(t, edges)
    H = theis(edges)
    n = 4
    half = tv.ExchangeSampler(n, nchains=256, seed=1).configs
    sampler = {
        "metropolis": lambda: tv.MetropolisHastingsSampler(n, nchains=256,
                                                           seed=1),
        "exchange": lambda: tv.ExchangeSampler(n, nchains=256, seed=1),
        "hamiltonian": lambda: tv.HamiltonianSampler.from_ham(
            H, n, nchains=256, initial=half, seed=1),
        "dense": lambda: tv.DenseSampler(t, seed=1),
        "cluster": lambda: tv.ClusterSampler(t, max_distance=1, seed=1),
    }[kind]()
    nchains = 64 if kind == "cluster" else 256
    vmc = tv.TNVMC(t, H, sampler=sampler, nchains=nchains, seed=2)
    if vmc.direct:
        configs, w = vmc._sample_direct(vmc.params)
    else:
        vmc._sample_batch(vmc.params, 3 * n)
        configs = vmc._sample_batch(vmc.params, vmc.sweeps_per_sample)
        w = torch.ones(configs.shape[0], dtype=torch.float64)
    e_loc = vmc._local_energies(vmc.params, configs)
    e = float(torch.mean(w * e_loc))
    se = float(torch.std(e_loc, correction=0)) / np.sqrt(configs.shape[0])
    if kind == "exchange":
        e_exact = _projected_energy(Hd, v, lambda k: k == 2)
    elif kind == "hamiltonian":
        e_exact = _projected_energy(Hd, v, lambda k: k % 2 == 0)
    assert abs(e - e_exact) < 5 * se + 1e-12, (e, e_exact, se)
    assert configs.dtype == torch.int64


def test_amplitude_factory_matches():
    j, t, _ = _peps_pair(3, 2, 2, 3)
    fj, ft = jv.AmplitudeFactory(j), tv.AmplitudeFactory(t)
    configs = np.random.default_rng(2).integers(0, 2, (6, 6))
    assert _rel(ft.amplitudes(configs), fj.amplitudes(configs)) <= TOL
    assert configs[0] in ft and ft[configs[0]] == ft.amplitude(configs[0])
    assert ft.prob(configs[1]) == pytest.approx(fj.prob(configs[1]),
                                                rel=TOL)
    ft[configs[2]] = 7.0
    assert ft.amplitude(configs[2]) == 7.0
    ft.update(params=[p * 2 for p in ft.params])
    assert configs[0] not in ft
    assert ft.amplitude(configs[0]) == pytest.approx(
        2 ** t.num_tensors * fj.amplitude(configs[0]), rel=TOL)
    assert repr(ft).startswith("<AmplitudeFactory(cached=1")


def test_conjugate_update_is_quimb_tpus_formula_with_o_conjugated():
    """The complex SR step: delta = S^-1 F with S = O^H O / n + damping and
    F = 2 O^H (E_loc - E) / n, O quimb_tpu's (centred) log-derivatives;
    computed in numpy from quimb_tpu's own O and local energies. quimb_tpu's
    own step, without the conjugation, lands elsewhere."""
    j, t, edges = CASES["peps-complex"]()
    vj = jv.TNVMC(j, jheis(edges), nchains=16, learning_rate=0.05,
                  sr_damping=1e-2)
    vt = tv.TNVMC(t, theis(edges), nchains=16, learning_rate=0.05,
                  sr_damping=1e-2)
    configs = np.random.default_rng(11).integers(0, 2, (16, vt.nsites))
    want = _conjugate_update(vj, configs, "sr", 0.05, 1e-2)
    vt._sample_batch = lambda params, k: torch.as_tensor(configs)
    vt.step()
    got = torch.cat([p.reshape(-1) for p in vt.params])
    assert _rel(got, want) <= TOL
    vj._sample_batch = lambda params, k: jnp.asarray(configs, jnp.int32)
    vj.step()
    assert _rel(got, np.concatenate([np.asarray(p).ravel()
                                     for p in vj.params])) > 1e-6


def test_conjugate_update_lowers_a_complex_start_faster():
    """From one complex 2 x 2 start with exact (dense) sampling, 10 SR
    steps of the port's update lower the energy by more than quimb_tpu's
    steps do, and as far as a real start's; on a real start the two
    packages take the same steps."""
    j, t, edges = _peps_pair(2, 2, 2, 1, cplx=True)
    H = theis(edges)
    out = {}
    for part in ("complex", "real"):
        if part == "complex":
            pj, pt = j.copy(), t.copy()
        else:
            pj = j.copy().apply_to_arrays(lambda x: jnp.real(x))
            pt = t.copy().apply_to_arrays(lambda x: x.real.contiguous())
        e0 = _exact_energy(pt, edges)[0]
        vt = tv.TNVMC(pt, H, sampler=tv.DenseSampler(pt, seed=0),
                      nchains=128, learning_rate=0.05)
        vj = jv.TNVMC(pj, jheis(edges), sampler=jv.DenseSampler(pj, seed=0),
                      nchains=128, learning_rate=0.05)
        for _ in range(10):
            vt.step()
            vj.step()
        out["port", part] = e0 - _exact_energy(vt.get_state(), edges)[0]
        out["quimb_tpu", part] = e0 - _exact_energy(
            convert.from_tpu_peps(vj.get_state(), device=CPU), edges)[0]
    assert out["port", "real"] == pytest.approx(out["quimb_tpu", "real"],
                                                rel=1e-8)
    assert out["port", "complex"] > 1.5 * out["quimb_tpu", "complex"]
    assert out["port", "complex"] > 0.8 * out["port", "real"]


def test_metropolis_chains_stay_on_their_device_and_read_nothing():
    _, t, edges = _peps_pair(2, 2, 2, 12)
    sam = tv.ExchangeSampler(4, nchains=8, seed=5)
    vmc = tv.TNVMC(t, theis(edges), sampler=sam, nchains=8)
    c1 = vmc._sample_batch(vmc.params, 6)
    assert c1.dtype == torch.int64 and c1.device.type == "cpu"
    assert (c1.sum(dim=1) == 2).all()
    # the same seed, the same chains
    sam2 = tv.ExchangeSampler(4, nchains=8, seed=5)
    vmc2 = tv.TNVMC(t, theis(edges), sampler=sam2, nchains=8)
    assert torch.equal(vmc2._sample_batch(vmc2.params, 6), c1)
    before = sum(tv.HOST_READS.values())
    vmc.run(2, progbar=False, burn_in=2)
    assert sum(tv.HOST_READS.values()) - before == 4
    assert len(vmc.energies) == len(vmc.energy_errors) == 2
