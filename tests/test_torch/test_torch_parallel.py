"""``quimb_torch.parallel`` against quimb_tpu's ``parallel``: the row-sharded
operator and its Krylov solvers, SLQ over the probes, sliced contraction,
the circuit's ``mesh=`` and the host pools, case for case as quimb_tpu's
``tests/test_parallel/test_mesh.py``, ``test_circuit_mesh.py`` and
``test_pools.py``; plus the chunked ELL layout, the world's own rules
(``get_mesh`` of another size raises, ``distributed_init`` joins an
existing world and re-raises a bad rendezvous) and ``dryrun_multichip(4)``.

quimb_tpu runs on one process's 8-device CPU mesh; the port on a world of 4
gloo ranks spawned once for the module (``_mesh_world``), on a (4,) mesh.
Every rank must return the same numbers, bit for bit. Random inputs are
quimb_tpu's (JAX's generator), carried across as numpy arrays.
"""

import jax
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import torch
import torch.distributed as dist

import quimb_tpu as qu
import quimb_tpu.tensor as qtn
import quimb_torch
from quimb_torch import convert
from quimb_torch.parallel import (
    can_use_mpi_pool,
    distributed_init,
    get_mesh,
    get_mpi_pool,
    get_thread_pool,
)
from quimb_tpu import parallel as jpar
from quimb_tpu.tensor.circuit import Circuit as JCircuit

from . import _mesh_cases as cases
from ._mesh_world import duck, same_on_every_rank, start

NPROCS = 4
BITS = ("000000", "101101", "111000")


def _skewed():
    """A symmetric matrix with one dense row and column among sparse ones:
    plain ELL would pad every row to 64 entries, past 4x the nonzeros."""
    B = sp.random(64, 64, density=0.03, random_state=3).tolil()
    B[5, :] = np.linspace(0.5, 1.5, 64)
    return (B + B.T).tocoo()


def _mps(L, chi, seed):
    psi = qtn.MPS_rand_state(L, chi, seed=seed, dtype="float64")
    return psi, duck(psi, L=psi.L, site_tag_id=psi.site_tag_id,
                     site_ind_id=psi.site_ind_id)


def _jcirc(n=6, rz=0.25):
    c = JCircuit(n)
    for q in range(n):
        c.h(q)
    for q in range(n - 1):
        c.cx(q, q + 1)
    for q in range(n):
        c.rz(rz + 0.1 * q, q)
    for q in range(0, n - 1, 2):
        c.cz(q, q + 1)
    return c


def _jmatvec(H, v, mesh):
    Hs = jpar.ShardedSparseHam(H, mesh=mesh)
    return {"y": Hs.to_host(Hs @ v), "chunked": Hs._S is not None}


def _dryrun_loss():
    """The loss of ``__graft_entry__.dryrun_multichip``'s training step,
    from its ``default_rng(0)`` parameters and batch (a (2, 2) mesh: 8
    configurations), in float64: the mean over the batch of -log(amp^2)."""
    rng = np.random.default_rng(0)
    params = [rng.standard_normal((4, 2, 4)) * 0.3 for _ in range(6)]
    vl, vr = rng.standard_normal(4), rng.standard_normal(4)
    configs = rng.integers(0, 2, (8, 6))
    amps = []
    for config in configs:
        env = vl
        for A, c in zip(params, config):
            env = env @ A[:, c, :]
        amps.append(env @ vr)
    return -np.mean(np.log(np.square(amps) + 1e-12))


def _dryrun_dmrg():
    """quimb_tpu's DMRG2 sweep of ``dryrun_multichip`` (L=16, chi=8, float32)
    from the port's start state: the two packages draw their random states
    from different generators."""
    p0 = quimb_torch.MPS_rand_state(16, 8, seed=2, dtype=torch.float32,
                                    device="cpu")
    dmrg = qtn.DMRG2(qtn.MPO_ham_heis(16), bond_dims=8, cutoffs=0.0,
                     p0=qtn.MatrixProductState([np.asarray(t.data)
                                                for t in p0.tensors]))
    return dmrg.sweep("R", max_bond=8, cutoff=0.0)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    A = sp.random(102, 102, density=0.1, random_state=1)
    A = ((A + A.T) / 2).tocoo()
    rho = np.asarray(qu.partial_trace(qu.rand_ket(2**10, seed=1),
                                      (2,) * 10, range(5)))
    mps10, mps10_duck = _mps(10, 8, 2)
    mps8, mps8_duck = _mps(8, 4, 3)
    tn = qtn.TN_rand_reg(10, 3, D=3, seed=11, dtype="float64")
    inputs = {"A100": A, "v100": np.random.default_rng(1).standard_normal(102),
              "skewed": _skewed(),
              "v_skewed": np.random.default_rng(2).standard_normal(64),
              "rho": rho, "mps10": mps10_duck, "mps8": mps8_duck,
              "rand_reg": duck(tn, exponent=tn.exponent), "bits": BITS}
    w = start(cases.PARALLEL_CASES, inputs, NPROCS,
              tmp_path_factory.mktemp("parallel"))

    # quimb_tpu's values on its 8-device mesh, computed while the world runs
    mesh = jpar.get_mesh(8, devices=jax.devices("cpu"))
    H9, H10, H8 = (qu.ham_heis(n, sparse=True) for n in (9, 10, 8))
    v8 = np.random.default_rng(0).standard_normal(2**8)
    norm10, norm8 = mps10.H & mps10, mps8.H & mps8
    fix = {0: "1", 1: "0"}
    ref = {
        "matvec_exact": _jmatvec(
            H9, np.random.default_rng(0).standard_normal(2**9), mesh),
        "row_slabs": jpar.ShardedSparseHam(qu.ham_heis(8, sparse=True),
                                           mesh=mesh),
        "non_power_of_two_dim": _jmatvec(A, inputs["v100"], mesh),
        "chunked_ell": _jmatvec(inputs["skewed"], inputs["v_skewed"], mesh),
        "groundstate": float(jpar.eigh_lanczos_sharded(
            H10, mesh=mesh, ncv=30, restarts=8)[0]),
        "exact10": np.linalg.eigvalsh(H10.toarray())[0],
        "expm": jpar.expm_multiply_sharded(H8, v8, t=-0.4, mesh=mesh,
                                           ncv=40),
        "expm_exact": sla.expm(-0.4 * H8.toarray()) @ v8,
        "slq": jpar.approx_spectral_sharded(
            rho, cases.clip, R=64, mesh=mesh, pos=True, seed=7),
        "sliced10": complex(jpar.contract_sliced(
            norm10, [mps10.bond(4, 5)], mesh=mesh)),
        "sliced8": complex(jpar.contract_sliced(
            norm8, [mps8.bond(2, 3), mps8.bond(5, 6)], mesh=mesh)),
        "marginal": np.asarray(_jcirc().compute_marginal(
            (0, 1), mesh=mesh)).reshape(-1),
        "conditional": np.asarray(_jcirc().compute_marginal(
            (2, 3), fix=fix, mesh=mesh)).reshape(-1),
        "samples": list(_jcirc(5).sample(40, seed=3, mesh=mesh)),
        "rand_reg": complex(np.asarray(jpar.contract_tn_mesh(
            tn, mesh=mesh, output_inds=()))),
        "amplitudes": [complex(np.asarray(_jcirc().amplitude(
            b, mesh=mesh)).item()) for b in BITS],
        # dryrun_multichip's circuit, marginal and draws
        "dryrun_marginal": np.asarray(_jcirc(rz=0.3).compute_marginal(
            (0, 1), mesh=mesh)).reshape(-1),
        "dryrun_samples": list(_jcirc(rz=0.3).sample(4, seed=7, mesh=mesh)),
        "dryrun_loss": _dryrun_loss(),
        "dryrun_dmrg": _dryrun_dmrg(),
    }
    return w, ref


def _case(world, name):
    """Rank 0's result of a case, after checking that every rank returned
    the same, bit for bit: the unsharded references too, since every rank
    simplifies the circuit's networks alike."""
    results = world[0].results()[name]
    for r in results:
        assert not (isinstance(r, tuple) and r[:1] == ("error",)), r[1]
    assert same_on_every_rank(results)
    return results[0]


# -- quimb_tpu's tests/test_parallel/test_mesh.py ---------------------------------


@pytest.mark.parametrize("case", ["matvec_exact", "non_power_of_two_dim",
                                  "chunked_ell"])
def test_sharded_matvec(world, case):
    got, want = _case(world, case), world[1][case]
    # the chunked layout where plain ELL would take over 4x the nonzeros,
    # in both packages
    assert got["chunked"] == want["chunked"] == (case == "chunked_ell")
    # 102 is not a multiple of 4 ranks: padded with two empty rows
    assert got["n_pad"] == {"non_power_of_two_dim": 104}.get(
        case, got["y"].size)
    np.testing.assert_allclose(got["y"], want["y"], rtol=0, atol=1e-12)


def test_row_slabs_match_mesh(world):
    got, want = _case(world, "row_slabs_match_mesh"), world[1]["row_slabs"]
    assert got["n_pad"] % NPROCS == 0 and got["n_pad"] == want.n_pad
    # one slab per rank: (ranks, rows, width), each rank holding its own
    assert got["placements"] == ["S(0)"]
    assert got["shape"][0] == NPROCS and got["local"][0] == 1
    assert got["shape"][1:] == got["local"][1:]
    assert len(want.V.sharding.device_set) == 8


def test_groundstate(world):
    got = _case(world, "groundstate")
    assert abs(got["lam"] - world[1]["groundstate"]) < 1e-10
    assert abs(got["lam"] - world[1]["exact10"]) < 1e-9


def test_expm(world):
    got = _case(world, "expm")
    np.testing.assert_allclose(got, world[1]["expm"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got, world[1]["expm_exact"], rtol=0,
                               atol=1e-10)


def test_slq(world):
    est, err = _case(world, "slq")
    want, want_err = world[1]["slq"]
    # the same probes through the same recurrence, without
    # reorthogonalisation, for K = n = 32 steps
    assert est == pytest.approx(want, rel=1e-8)
    assert err == pytest.approx(want_err, rel=1e-6)
    assert abs(est - 1.0) < 0.05


@pytest.mark.parametrize("case, key", [
    ("contract_sliced_matches_direct", "sliced10"),
    ("contract_sliced_two_inds", "sliced8"),
])
def test_contract_sliced(world, case, key):
    got = _case(world, case)
    assert abs(got["sliced"] - got["full"]) < 1e-10 * abs(got["full"])
    assert abs(got["sliced"] - world[1][key]) < 1e-10 * abs(got["full"])


# -- quimb_tpu's tests/test_parallel/test_circuit_mesh.py ------------------------


@pytest.mark.parametrize("case, key", [
    ("marginal_matches_single_device", "marginal"),
    ("conditional_marginal_matches", "conditional"),
])
def test_marginal_matches(world, case, key):
    got = _case(world, case)
    assert got["mesh"].shape == (4,)
    np.testing.assert_allclose(got["mesh"], got["ser"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["mesh"], world[1][key], rtol=0,
                               atol=1e-12)
    assert got["mesh"].sum() == pytest.approx(1.0, abs=1e-12)


def test_sample_statistics_match(world):
    got = _case(world, "sample_statistics_match")
    assert all(len(s) == 5 for s in got["mesh"])
    # identical seeds and marginals: identical samples, in both packages
    assert got["mesh"] == got["ser"] == world[1]["samples"]


def test_contract_sliced_exactness(world):
    got = _case(world, "contract_tn_mesh_exactness")
    assert got["mesh"] == pytest.approx(got["ser"], rel=1e-10)
    assert got["mesh"] == pytest.approx(world[1]["rand_reg"], rel=1e-10)


def test_amplitude_mesh(world):
    got = _case(world, "amplitude_mesh")
    tol = 1e-12 * np.abs(world[1]["amplitudes"]).max()
    np.testing.assert_allclose(got["mesh"], got["ser"], rtol=1e-12, atol=tol)
    np.testing.assert_allclose(got["mesh"], world[1]["amplitudes"],
                               rtol=1e-12, atol=tol)


# -- the world's own rules ---------------------------------------------------------


def test_get_mesh_of_another_size_raises(world):
    msg = _case(world, "get_mesh_other_size_raises")
    assert msg is not None and "world of 4 ranks" in msg


def test_distributed_init_joins_an_existing_world(world):
    assert _case(world, "distributed_init_joins_existing_world") is True


def test_distributed_init_reraises(monkeypatch):
    """With no world, a rendezvous that cannot start raises to the caller
    (quimb_tpu swallows RuntimeError and ValueError), and no group is left
    behind."""
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        distributed_init(backend="gloo")
    assert not dist.is_initialized()


def test_get_mesh_without_cuda_raises():
    """Entry points run on the card unless asked for the CPU: with no CUDA
    and no ``device="cpu"`` no world is started."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_mesh()
    assert not dist.is_initialized()


def test_get_mesh_from_devices(world):
    """``devices=`` gives quimb_tpu's mesh shapes and axis names over as
    many devices; a list of another length than the world raises."""
    from quimb_tpu.parallel.mesh import get_mesh_2d as jmesh_2d

    got = _case(world, "get_mesh_from_devices")
    cpus = jax.devices("cpu")
    for key, m in (
            ("1d", jpar.get_mesh(devices=cpus[:NPROCS])),
            ("2d", jmesh_2d(devices=cpus[:NPROCS])),
            ("first_n", jpar.get_mesh(NPROCS, devices=cpus[:NPROCS + 2]))):
        assert got[key] == (m.devices.shape, tuple(m.axis_names))
    assert got["short"].startswith(f"{NPROCS - 1} devices given for a "
                                   f"world of {NPROCS} ranks")


def test_dryrun_multichip(world):
    got, ref = _case(world, "dryrun"), world[1]
    assert got["mesh"] == (2, 2)
    # float32 parameters, as in quimb_tpu's step
    assert got["loss"] == pytest.approx(ref["dryrun_loss"], rel=1e-5)
    assert got["dmrg_energy"] == pytest.approx(ref["dryrun_dmrg"], rel=1e-5)
    # identical seeds and marginals: identical samples, in both packages
    assert got["samples"] == ref["dryrun_samples"]
    np.testing.assert_allclose(got["p_mesh"], got["p_ser"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got["p_mesh"], ref["dryrun_marginal"],
                               rtol=0, atol=1e-12)


# -- quimb_tpu's tests/test_parallel/test_pools.py -------------------------------


def test_thread_pool_submit():
    pool = get_thread_pool(2)
    futs = [pool.submit(lambda x: x * x, i) for i in range(8)]
    assert [f.result() for f in futs] == [i * i for i in range(8)]


def test_mpi_pool_is_shim():
    assert can_use_mpi_pool() is False is jpar.can_use_mpi_pool()
    assert get_mpi_pool(2).submit(sum, (1, 2, 3)).result() == 6
    assert get_mpi_pool(2) is get_thread_pool(2)


def test_thread_pool_cached():
    assert get_thread_pool(3) is get_thread_pool(3)
    assert quimb_torch.get_thread_pool is get_thread_pool


@pytest.fixture(scope="module")
def psi_terms():
    j = qtn.TN_from_edges_rand([(0, 1), (1, 2), (2, 3), (3, 0)], D=3,
                               phys_dim=2, seed=7, dtype="float64")
    H2 = np.asarray(qu.ham_heis(2, cyclic=False, sparse=False))
    terms = {(0, 1): H2, (1, 2): H2, (2, 3): H2, (3, 0): H2}
    return j, convert.from_tpu_tngen(j, device="cpu"), terms


@pytest.mark.parametrize("method, rel", [("exact", 1e-10),
                                         ("cluster", 1e-8)])
def test_executor_matches_serial(psi_terms, method, rel):
    j, t, terms = psi_terms
    want = complex(j.compute_local_expectation(terms, method=method))
    ser = complex(t.compute_local_expectation(terms, method=method))
    par = complex(t.compute_local_expectation(
        terms, method=method, executor=get_thread_pool(2)))
    assert par == pytest.approx(ser, rel=rel)
    assert par == pytest.approx(want, rel=rel)


def test_executor_return_all(psi_terms):
    _, t, terms = psi_terms
    r = t.compute_local_expectation(terms, method="exact", return_all=True,
                                    executor=get_thread_pool(2))
    assert set(r) == set(terms)


def test_eager_executor_sum():
    from quimb_torch.tensor import MultiLossHandler

    jmps = qtn.MPS_rand_state(6, 4, seed=1, dtype="float64")
    mps = convert.from_tpu_mps(jmps, device="cpu")

    def l1(tn):
        return (tn @ tn.H).real

    def l2(tn):
        return 2.0 * (tn @ tn.H).real

    h = MultiLossHandler([l1, l2], executor=get_thread_pool(2))
    got = float(h(mps))
    assert got == pytest.approx(float(l1(mps)) + float(l2(mps)), rel=1e-12)
    assert got == pytest.approx(float(l1(jmps)) + float(l2(jmps)), rel=1e-12)


def test_optimizer_accepts_loss_list():
    jtarget = qtn.MPS_rand_state(5, 3, seed=3, dtype="float64")
    jpsi0 = qtn.MPS_rand_state(5, 3, seed=4, dtype="float64")
    losses = {}
    for name, pkg, target, psi0 in (
            ("quimb_tpu", qtn, jtarget, jpsi0),
            ("port", quimb_torch, convert.from_tpu_mps(jtarget, device="cpu"),
             convert.from_tpu_mps(jpsi0, device="cpu"))):

        def loss_overlap(tn, target=target):
            return -((tn @ target.H).real ** 2)

        def loss_norm(tn):
            return ((tn @ tn.H).real - 1.0) ** 2

        opts = dict(optimizer="adam", learning_rate=0.05, progbar=False)
        opt_list = pkg.TNOptimizer(psi0.copy(), [loss_overlap, loss_norm],
                                   **opts)
        opt_sum = pkg.TNOptimizer(
            psi0.copy(), lambda tn: loss_overlap(tn) + loss_norm(tn), **opts)
        opt_list.optimize(10)
        opt_sum.optimize(10)
        assert opt_list.loss == pytest.approx(opt_sum.loss, rel=1e-8)
        losses[name] = opt_list.loss
    assert losses["port"] == pytest.approx(losses["quimb_tpu"], rel=1e-8)
