"""The cases that ``test_torch_parallel.py`` and ``test_torch_mesh_dmrg.py``
run on every rank of a gloo world (``_mesh_world.py``): each a function
of the inputs the parent made, returning plain numbers, strings and numpy
arrays. This module imports torch and quimb_torch only."""

import functools

import numpy as np
import torch

import quimb_torch as qt
from quimb_torch import convert
from quimb_torch.parallel import (
    ShardedSparseHam,
    approx_spectral_sharded,
    contract_sliced,
    contract_tn_mesh,
    distributed_init,
    dryrun_multichip,
    eigh_lanczos_sharded,
    expm_multiply_sharded,
    get_mesh,
    get_mesh_2d,
    mesh_put,
)
from quimb_torch.tensor.circuit import Circuit

from ._mesh_world import late

CPU = "cpu"


@functools.cache
def mesh1():
    return get_mesh(device=CPU)


@functools.cache
def mesh2():
    return get_mesh_2d(device=CPU)


def build_circ(n=6):
    """quimb_tpu's test circuit (tests/test_parallel/test_circuit_mesh.py)."""
    c = Circuit(n, device=CPU)
    for q in range(n):
        c.h(q)
    for q in range(n - 1):
        c.cx(q, q + 1)
    for q in range(n):
        c.rz(0.25 + 0.1 * q, q)
    for q in range(0, n - 1, 2):
        c.cz(q, q + 1)
    return c


def clip(x):
    return np.clip(x, 0, None)


# -- quimb_tpu's tests/test_parallel/test_mesh.py ---------------------------------


def _sharded_matvec(H, v):
    Hs = ShardedSparseHam(H, mesh=mesh1())
    return {"y": Hs.to_host(Hs @ v), "chunked": Hs._S is not None,
            "n_pad": Hs.n_pad}


def matvec_exact(inp):
    return _sharded_matvec(qt.ham_heis(9, sparse=True),
                           np.random.default_rng(0).standard_normal(2**9))


def row_slabs_match_mesh(inp):
    Hs = ShardedSparseHam(qt.ham_heis(8, sparse=True), mesh=mesh1())
    return {"n_pad": Hs.n_pad, "shape": tuple(Hs.V.shape),
            "local": tuple(Hs.V.to_local().shape),
            "placements": [str(p) for p in Hs.V.placements]}


def non_power_of_two_dim(inp):
    return _sharded_matvec(inp["A100"], inp["v100"])


def chunked_ell(inp):
    return _sharded_matvec(inp["skewed"], inp["v_skewed"])


def groundstate(inp):
    lam, gs = eigh_lanczos_sharded(qt.ham_heis(10, sparse=True),
                                   mesh=mesh1(), ncv=30, restarts=8)
    return {"lam": float(lam), "gs": gs}


def expm(inp):
    v = np.random.default_rng(0).standard_normal(2**8)
    return expm_multiply_sharded(qt.ham_heis(8, sparse=True), v, t=-0.4,
                                 mesh=mesh1(), ncv=40)


def slq(inp):
    return approx_spectral_sharded(inp["rho"], clip, R=64, mesh=mesh1(),
                                   pos=True, seed=7)


def _norm_sliced(mps, bonds):
    psi = convert.from_tpu_mps(mps, device=CPU)
    norm = psi.H & psi
    cuts = [psi.bond(*b) for b in bonds]
    return {"sliced": complex(contract_sliced(norm, cuts, mesh=mesh1())),
            "full": complex(norm.contract(...))}


def contract_sliced_matches_direct(inp):
    return _norm_sliced(inp["mps10"], [(4, 5)])


def contract_sliced_two_inds(inp):
    return _norm_sliced(inp["mps8"], [(2, 3), (5, 6)])


# -- quimb_tpu's tests/test_parallel/test_circuit_mesh.py ------------------------


def marginal_matches_single_device(inp):
    return {"mesh": build_circ().compute_marginal((0, 1), mesh=mesh1()),
            "ser": build_circ().compute_marginal((0, 1))}


def conditional_marginal_matches(inp):
    fix = {0: "1", 1: "0"}
    return {"mesh": build_circ().compute_marginal((2, 3), fix=fix,
                                                  mesh=mesh1()),
            "ser": build_circ().compute_marginal((2, 3), fix=fix)}


def sample_statistics_match(inp):
    return {"mesh": list(build_circ(5).sample(40, seed=3, mesh=mesh1())),
            "ser": list(build_circ(5).sample(40, seed=3))}


def contract_tn_mesh_exactness(inp):
    tn = convert.from_tpu_tensor_network(inp["rand_reg"], device=CPU)
    return {"mesh": complex(contract_tn_mesh(tn, mesh=mesh1())),
            "ser": complex(tn.contract(...))}


def amplitude_mesh(inp):
    c = build_circ()
    return {"mesh": [c.amplitude(b, mesh=mesh1()) for b in inp["bits"]],
            "ser": [c.amplitude(b) for b in inp["bits"]]}


# -- the world itself ------------------------------------------------------------


def get_mesh_other_size_raises(inp):
    try:
        get_mesh(3, device=CPU)
    except ValueError as e:
        return str(e)
    return None


def distributed_init_joins_existing_world(inp):
    # a group exists: the call returns before reading its arguments
    return distributed_init(backend="no-such-backend") is None


def dryrun(inp):
    out = dryrun_multichip(4, device=CPU)
    out["mesh"] = tuple(out["mesh"])
    return out


def get_mesh_from_devices(inp):
    """quimb_tpu's ``devices=``: one device a rank (the first ``n`` with
    ``n``); a list of another length raises."""
    n = torch.distributed.get_world_size()

    def shape(m):
        return tuple(m.shape), tuple(m.mesh_dim_names)

    out = {"1d": shape(get_mesh(devices=[CPU] * n)),
           "2d": shape(get_mesh_2d(devices=[torch.device(CPU)] * n)),
           "first_n": shape(get_mesh(n, devices=[CPU] * (n + 2)))}
    try:
        get_mesh(devices=[CPU] * (n - 1))
    except ValueError as e:
        out["short"] = str(e)
    return out


PARALLEL_CASES = [(f.__name__, f) for f in (
    matvec_exact, row_slabs_match_mesh, non_power_of_two_dim, chunked_ell,
    groundstate, expm, slq, contract_sliced_matches_direct,
    contract_sliced_two_inds, marginal_matches_single_device,
    conditional_marginal_matches, sample_statistics_match,
    contract_tn_mesh_exactness, amplitude_mesh, get_mesh_other_size_raises,
    distributed_init_joins_existing_world, dryrun, get_mesh_from_devices)]


# -- quimb_tpu's tests/test_parallel/test_mesh_dmrg.py ---------------------------


def mesh_put_divisible_axes_sharded(inp):
    x = mesh_put(torch.ones((16, 3, 16)), mesh2(), ("dl", None, "dr"))
    return {"placements": [str(p) for p in x.placements],
            "local": tuple(x.to_local().shape)}


def mesh_put_indivisible_axis_replicated(inp):
    x = mesh_put(torch.ones((1, 3, 16)), mesh2(), ("dl", None, "dr"))
    return {"placements": [str(p) for p in x.placements],
            "local": tuple(x.to_local().shape)}


#: the sweeps of the DMRG cases: R (canonized), L, R, ...
SWEEPS = [("R", True), ("L", False), ("R", False), ("L", False),
          ("R", False), ("L", False), ("R", False), ("L", False)]
#: DMRG1's Lanczos basis in these cases: quimb_tpu builds its default 8
#: vectors past the 4-dimensional space of a chain end, and their spurious
#: Ritz values reach its energies (ROADMAP section 3)
DMRG1_OPTS = {"local_eig_ncv": 2, "local_eig_ncv_floor": 4}


def _sweeps(cls, p0, L, chi, shard, nsweeps, opts=None):
    H = qt.MPO_ham_heis(L, device=CPU)
    dmrg = cls(H, bond_dims=chi, cutoffs=0.0,
               p0=convert.from_tpu_mps(p0, device=CPU))
    dmrg.opts.update(opts or {})
    if shard:
        dmrg.shard_onto(mesh2())
    ens = [dmrg.sweep(d, max_bond=chi, cutoff=0.0, canonize=c)
           for d, c in SWEEPS[:nsweeps]]
    return ens, dmrg


def sharded_sweeps_match_single_device(inp):
    return {shard: _sweeps(qt.DMRG2, inp["p0_12_7"], 12, 6, shard, 3)[0]
            for shard in ("", "sharded")}


def dmrg1_sharded_sweeps_match(inp):
    p0 = late(inp, "dmrg2_12_7")
    return {shard: _sweeps(qt.DMRG1, p0, 12, 6, shard, 3, DMRG1_OPTS)[0]
            for shard in ("", "sharded")}


def bulk_arrays_really_sharded(inp):
    (en_sweep,), dmrg = _sweeps(qt.DMRG2, inp["p0_24_3"], 24, 8, True, 1)
    renv, lenv = dmrg._build_right_envs(), dmrg._build_left_envs()
    psi, H = dmrg.state, dmrg.ham
    en = complex(qt.expec_TN_1D(psi.H, H.apply(psi))).real
    nrm = complex(qt.expec_TN_1D(psi.H, psi)).real

    def where(env):
        return ([str(p) for p in env.placements], tuple(env.shape),
                tuple(env.to_local().shape))

    return {"en_sweep": en_sweep, "en": en / nrm,
            "renv": [where(renv[j]) for j in (2, 12, 24)],
            "lenv": [where(lenv[j]) for j in (0, 12, 21)]}


def dmrgx_sharded_sweeps_match(inp):
    """DMRGX (L=12) unsharded and under ``shard_onto``: every rank runs
    the whole sweep."""
    H = qt.MPO_ham_heis(12, j=(1.0, 1.0, 1.3), device=CPU)
    out = {}
    for shard in ("", "sharded"):
        dmrg = qt.DMRGX(H, convert.from_tpu_mps(inp["neel_12"], device=CPU),
                        bond_dims=8, cutoffs=0.0)
        if shard:
            dmrg.shard_onto(mesh2())
        out[shard] = [dmrg.sweep(d, max_bond=8, cutoff=0.0, canonize=c)
                      for d, c in SWEEPS[:2]]
    return out


def ring_shard_onto_raises(inp):
    """The ring engine (L=40, segmented) refuses ``shard_onto``."""
    dmrg = qt.DMRG2(qt.MPO_ham_heis(40, cyclic=True, device=CPU),
                    bond_dims=8, cutoffs=0.0,
                    p0=qt.MPS_rand_state(40, 8, seed=3, cyclic=True,
                                         device=CPU),
                    cyclic_mode="segmented")
    try:
        dmrg.shard_onto(mesh2())
    except NotImplementedError as e:
        return {"ring": dmrg._cyc is not None, "error": str(e)}
    return None


def sharded_solve_converges_to_exact(inp):
    return _sweeps(qt.DMRG2, inp["p0_16_11"], 16, 32, True, 8)[0][-1]


def _tebd(L, shard):
    psi0 = qt.MPS_neel_state(L, device=CPU).astype(torch.complex128)
    tebd = qt.TEBD(psi0, qt.ham_1d_heis(L),
                   split_opts={"max_bond": 16, "cutoff": 1e-12}, fused=True)
    if shard:
        tebd.shard_onto(mesh1())
    es = []
    for k in range(1, 4):
        tebd.update_to(k * 0.1, dt=0.05, order=2)
        es.append(float(tebd.pt.entropy(L // 2)))
    tebd.update_to(0.35, dt=0.05, order=2)
    return tebd, {"entropies": es, "trunc_err": tebd.trunc_err}


def _tebd_pair(L):
    """The same quench unsharded and sharded; under "own", this rank's
    block of the sharded stacks against the same rows of the unsharded
    ones (each rank's own numbers)."""
    ser, out = _tebd(L, False)
    shd, out_shd = _tebd(L, True)
    _, _, rank, edges = shd._shard
    lo, hi = int(edges[rank]), int(edges[rank + 1])
    (Bs, ls), (B_all, l_all) = shd._ensure_vidal(), ser._ensure_vidal()
    return {"": out, "sharded": out_shd, "own": {
        "rows": (lo, hi), "sites": Bs.shape[0],
        "block_err": float(torch.max(torch.abs(Bs - B_all[lo:hi]))),
        "weights_err": float(torch.max(torch.abs(ls - l_all[lo:hi + 1])))}}


def sharded_fused_tebd_matches_single_device(inp):
    return _tebd_pair(16)


def sharded_tebd_uneven_blocks(inp):
    return _tebd_pair(18)


MESH_DMRG_CASES = [(f.__name__, f) for f in (
    mesh_put_divisible_axes_sharded, mesh_put_indivisible_axis_replicated,
    sharded_sweeps_match_single_device, bulk_arrays_really_sharded,
    sharded_solve_converges_to_exact,
    sharded_fused_tebd_matches_single_device, sharded_tebd_uneven_blocks,
    dmrg1_sharded_sweeps_match, dmrgx_sharded_sweeps_match,
    ring_shard_onto_raises)]
