"""The sharded engines against quimb_tpu: ``mesh_put``, ``DMRG.shard_onto``
(DMRG2 and DMRG1) and ``TEBD.shard_onto``, case for case as quimb_tpu's
``tests/test_parallel/test_mesh_dmrg.py``, plus DMRG1 and a chain that
does not split evenly.

quimb_tpu runs its cases on one process's 8-device CPU mesh; the port's run
on a world of 4 gloo ranks spawned once for the module (``_mesh_world``),
with a (2, 2) mesh for DMRG and a (4,) mesh for TEBD. Every rank must
return the same numbers, bit for bit. quimb_tpu's references here are its
unsharded DMRG and TEBD engines, which its own tests hold to its sharded
ones at 1e-9 and 1e-12; computing its sharded runs would double this
file's time. Start states are quimb_tpu's ``MPS_rand_state`` arrays.
"""

import concurrent.futures

import numpy as np
import pytest
import scipy.sparse.linalg as spla

import quimb_tpu as qu
import quimb_tpu.tensor as qtn

from . import _mesh_cases as cases
from ._mesh_world import duck, same_on_every_rank, start

NPROCS = 4


def _duck(psi):
    return duck(psi, L=psi.L, site_tag_id=psi.site_tag_id,
                site_ind_id=psi.site_ind_id)


def _p0(L, chi, seed):
    return qtn.MPS_rand_state(L, chi, seed=seed, dtype="float64")


def _quimb_tpu_sweeps(cls, p0, chi, nsweeps, opts=None):
    dmrg = cls(qtn.MPO_ham_heis(p0.L), bond_dims=chi, cutoffs=0.0, p0=p0)
    dmrg.opts.update(opts or {})
    ens = [dmrg.sweep(d, max_bond=chi, cutoff=0.0, canonize=c)
           for d, c in cases.SWEEPS[:nsweeps]]
    return ens, dmrg


def _quimb_tpu_quench(L):
    """quimb_tpu's fused TEBD on the cases' quench (``_mesh_cases._tebd``):
    half-chain entropies at t = 0.1, 0.2, 0.3, and the truncation error
    at 0.35."""
    psi0 = qtn.MPS_neel_state(L).astype("complex128")
    tebd = qtn.TEBD(psi0, qtn.ham_1d_heis(L),
                    split_opts={"max_bond": 16, "cutoff": 1e-12}, fused=True,
                    progbar=False)
    es = []
    for k in range(1, 4):
        tebd.update_to(k * 0.1, dt=0.05, order=2, progbar=False)
        es.append(float(np.real(tebd.pt.entropy(L // 2))))
    tebd.update_to(0.35, dt=0.05, order=2, progbar=False)
    return {"entropies": es, "trunc_err": float(tebd.trunc_err)}


def _quimb_tpu_dmrgx():
    """quimb_tpu's unsharded DMRGX (its sharded one returns the same
    energies to 1e-10) on the world's case: L=12, anisotropic Heisenberg,
    from the Neel state."""
    dmrg = qtn.DMRGX(qtn.MPO_ham_heis(12, j=(1.0, 1.0, 1.3)),
                     qtn.MPS_neel_state(12), bond_dims=8, cutoffs=0.0)
    return [dmrg.sweep(d, max_bond=8, cutoff=0.0, canonize=c)
            for d, c in cases.SWEEPS[:2]]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    p0 = _p0(12, 6, 7)
    inputs = {"p0_12_7": _duck(p0), "p0_24_3": _duck(_p0(24, 8, 3)),
              "p0_16_11": _duck(_p0(16, 32, 11)),
              "neel_12": _duck(qtn.MPS_neel_state(12))}
    w = start(cases.MESH_DMRG_CASES, inputs, NPROCS,
              tmp_path_factory.mktemp("mesh_dmrg"))
    # quimb_tpu's quenches compile in a thread of their own meanwhile
    pool = concurrent.futures.ThreadPoolExecutor(1)
    quenches = pool.submit(lambda: [_quimb_tpu_quench(L) for L in (16, 18)])
    # quimb_tpu's values, computed while the world runs. DMRG1 starts from
    # the DMRG2 state after one sweep, whose bonds a one-site sweep can
    # keep (a random start's bonds exceed what the chain's ends hold), at
    # test_torch_dmrg1.py's L=12, chi=6; the world's last case reads it
    (en,), dmrg2 = _quimb_tpu_sweeps(qtn.DMRG2, p0, 6, 1)
    state = dmrg2.state
    w.send("dmrg2_12_7", _duck(state))
    ens = [en] + [dmrg2.sweep(d, max_bond=6, cutoff=0.0, canonize=c)
                  for d, c in cases.SWEEPS[1:3]]
    ref = {
        "dmrg2": ens,
        "dmrg1": _quimb_tpu_sweeps(qtn.DMRG1, state, 6, 3,
                                   cases.DMRG1_OPTS)[0],
        "exact16": spla.eigsh(qu.ham_heis(16, sparse=True), k=1,
                              which="SA")[0][0],
        "dmrgx": _quimb_tpu_dmrgx(),
    }
    ref["tebd16"], ref["tebd18"] = quenches.result()
    pool.shutdown()
    return w, ref


def _case(world, name):
    """Rank 0's result of a case, after checking that every rank returned
    the same, bit for bit (but for the rank's "own" numbers)."""
    results = world[0].results()[name]
    for r in results:
        assert not (isinstance(r, tuple) and r[:1] == ("error",)), r[1]
    assert same_on_every_rank([{k: v for k, v in r.items() if k != "own"}
                               if isinstance(r, dict) else r
                               for r in results])
    return results[0]


def test_divisible_axes_sharded(world):
    from jax.sharding import PartitionSpec as P
    from quimb_tpu.parallel.mesh import get_mesh_2d as jmesh_2d
    from quimb_tpu.parallel.mesh import mesh_put as jput

    import jax.numpy as jnp

    got = _case(world, "mesh_put_divisible_axes_sharded")
    spec = jput(jnp.ones((16, 3, 16)), jmesh_2d(), P("dl", None, "dr")
                ).sharding.spec
    assert spec[0] == "dl" and spec[2] == "dr"
    # (dl, dr) = (2, 2): dim 0 over dl, dim 2 over dr
    assert got == {"placements": ["S(0)", "S(2)"], "local": (8, 3, 8)}


def test_indivisible_axis_replicated(world):
    got = _case(world, "mesh_put_indivisible_axis_replicated")
    # a size-1 axis cannot shard over 2 ranks: replicated
    assert got == {"placements": ["R", "S(2)"], "local": (1, 3, 8)}


def test_sharded_sweeps_match_single_device(world):
    got = _case(world, "sharded_sweeps_match_single_device")
    # the blocks' sums round differently from the whole products
    np.testing.assert_allclose(got["sharded"], got[""], rtol=0, atol=1e-12)
    # quimb_tpu's own sharded sweeps meet its unsharded ones at 1e-9
    np.testing.assert_allclose(got["sharded"], world[1]["dmrg2"], rtol=0,
                               atol=1e-9)


def test_dmrg1_sharded_sweeps_match(world):
    got = _case(world, "dmrg1_sharded_sweeps_match")
    np.testing.assert_allclose(got["sharded"], got[""], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["sharded"], world[1]["dmrg1"], rtol=0,
                               atol=1e-9)


def test_dmrgx_sharded_sweeps_match(world):
    """``DMRGX.shard_onto`` runs the whole sweep on every rank: the
    unsharded arithmetic, bit for bit; quimb_tpu's energies to 1e-10 (dense
    float64 eighs of the same local operators)."""
    got = _case(world, "dmrgx_sharded_sweeps_match")
    assert got["sharded"] == got[""]
    np.testing.assert_allclose(got["sharded"], world[1]["dmrgx"], rtol=0,
                               atol=1e-10)


def test_ring_shard_onto_raises_in_both(world):
    """A ring (L=40, segmented) is not sharded in either package: the
    port refuses it, and quimb_tpu's ``shard_onto`` reads the site list
    ``_A``, which its ring engine never builds."""
    from quimb_tpu.parallel.mesh import get_mesh_2d as jmesh_2d

    got = _case(world, "ring_shard_onto_raises")
    assert got["ring"] and "open chain" in got["error"]
    j = qtn.DMRG2(qtn.MPO_ham_heis(40, cyclic=True), bond_dims=8,
                  cutoffs=0.0, p0=qtn.MPS_rand_state(40, 8, seed=3,
                                                     cyclic=True,
                                                     dtype="float64"),
                  cyclic_mode="segmented")
    assert j._cyc is not None
    with pytest.raises(AttributeError, match="_A"):
        j.shard_onto(jmesh_2d())


def test_bulk_arrays_really_sharded(world):
    got = _case(world, "bulk_arrays_really_sharded")
    # right environments sharded over dr (mesh dim 1), left ones over dl
    # (dim 0); the (1, 1, 1) ends, whose size does not divide 2, replicated
    assert got["renv"][1] == (["R", "S(0)"], (8, 5, 8), (4, 5, 8))
    assert got["lenv"][1] == (["S(0)", "R"], (8, 5, 8), (4, 5, 8))
    assert got["renv"][2] == (["R", "R"], (1, 1, 1), (1, 1, 1))
    assert got["lenv"][0] == (["R", "R"], (1, 1, 1), (1, 1, 1))
    # and the state is an MPS reproducing the sweep's energy
    assert abs(got["en"] - got["en_sweep"]) < 1e-8


def test_sharded_solve_converges_to_exact(world):
    en = _case(world, "sharded_solve_converges_to_exact")
    assert abs(en - world[1]["exact16"]) < 1e-6


@pytest.mark.parametrize("case, L", [
    ("sharded_fused_tebd_matches_single_device", 16),
    ("sharded_tebd_uneven_blocks", 18),
])
def test_sharded_fused_tebd_matches_single_device(world, case, L):
    got = _case(world, case)
    ser, shd, ref = got[""], got["sharded"], world[1][f"tebd{L}"]
    for want in (ser, ref):
        np.testing.assert_allclose(shd["entropies"], want["entropies"],
                                   rtol=0, atol=1e-12)
        assert shd["trunc_err"] == pytest.approx(want["trunc_err"],
                                                 rel=1e-10, abs=1e-15)
    # each rank holds only its block of the stack, the weights at both its
    # edges: contiguous blocks of ceil or floor(L / 4) sites
    own = [r["own"] for r in world[0].results()[case]]
    edges = np.cumsum([0] + [len(b) for b in np.array_split(range(L),
                                                             NPROCS)])
    assert [o["rows"] for o in own] == list(zip(edges[:-1], edges[1:]))
    assert [o["sites"] for o in own] == list(np.diff(edges))
    assert max(o["block_err"] for o in own) <= 1e-12
    assert max(o["weights_err"] for o in own) <= 1e-12
