"""Record quimb_tpu's float64 values for ``chip_smoke.py``'s phase 29.

Parts (each may run alone; they merge into
``scripts/slice16_reference.json``):

- ``vmc``: the start state and quimb_tpu's fixed-configuration values of
  TNVMC on the 6 x 6 open-boundary spin-1/2 Heisenberg PEPS at D=4. The
  start is a SimpleUpdate state: a PEPS of ``default_rng(16)`` arrays in
  ``PEPS_rand``'s shapes (axes ``urdlp``), evolved by quimb_tpu's
  ``SimpleUpdate`` (``ham_2d_heis(6, 6)``, D=4, ``nits`` steps at each of
  tau = 0.3, 0.1), then each tensor divided by its largest magnitude (the
  state is unnormalised; VMC reads only ratios and |psi|^2 weights). For
  128 fixed S^z = 0 configurations from ``default_rng(29)`` it records the
  amplitudes, the local energies, ``O @ v`` for a fixed ``v`` from
  ``default_rng(31)`` and one SR step's ``delta`` (the vector, its norm
  and ``delta . v``; learning rate 0.05, damping 1e-3, unit weights) with
  the condition number of that step's S matrix, and the
  state's exact energy per ``compute_local_expectation(max_bond=chi,
  normalized=True)`` at chi = 32 and 64 (a boundary contraction; the two
  show how far it has converged).
- ``ctmrg``: ``ctmrg_partition_function`` of the 2D classical Ising model
  at beta_c = log(1 + sqrt 2) / 2 on an L x L lattice (L = 256) at
  ``max_bond`` 32, as log10 Z (``strip_exponent``).

JAX runs on the CPU in float64. Run from the root of the repository::

    JAX_PLATFORMS=cpu python scripts/slice16_reference.py [vmc] [ctmrg]

``python scripts/slice16_reference.py vmc 2 3 3 8 out.json`` records the
same quantities for an Lx x Ly = 2 x 3 lattice at D=3 with 8 configurations
and 8 SimpleUpdate steps (a rehearsal size) into ``out.json``.
"""

import json
import math
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

OUT = os.path.join(HERE, "slice16_reference.json")
VMC_SEEDS = {"arrays": 16, "configs": 29, "v": 31}
BETA_C = math.log(1 + math.sqrt(2)) / 2


def start_arrays(Lx, Ly, D, seed, phys_dim=2):
    """``PEPS_rand``'s shapes (u, r, d, l, p with the edge bonds dropped),
    drawn site by site, row-major, from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal(
        [D] * sum((i < Lx - 1, j < Ly - 1, i > 0, j > 0)) + [phys_dim])
        for j in range(Ly)] for i in range(Lx)]


def heisenberg_edges(Lx, Ly):
    """The nearest-neighbour bonds of the open Lx x Ly lattice, sites
    numbered row-major (the PEPS's site order)."""
    edges = []
    for i in range(Lx):
        for j in range(Ly):
            if i + 1 < Lx:
                edges.append((i * Ly + j, (i + 1) * Ly + j))
            if j + 1 < Ly:
                edges.append((i * Ly + j, i * Ly + j + 1))
    return edges


def fixed_configs(nsites, n, seed):
    """``n`` configurations with half the spins up, from
    ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    base = np.array([1] * (nsites // 2) + [0] * (nsites - nsites // 2))
    return np.stack([rng.permutation(base) for _ in range(n)])


def vmc(Lx=6, Ly=6, D=4, nconf=128, nits=20):
    import jax.numpy as jnp

    import quimb_tpu.tensor as qtn
    from quimb_tpu.experimental.tnvmc import TNVMC
    from quimb_tpu.operator import heisenberg_from_edges

    out = {"Lx": Lx, "Ly": Ly, "D": D, "nconf": nconf, "nits": nits,
           "seeds": VMC_SEEDS}
    t0 = time.perf_counter()
    psi0 = qtn.PEPS(start_arrays(Lx, Ly, D, VMC_SEEDS["arrays"]),
                    shape="urdlp")
    ham = qtn.ham_2d_heis(Lx, Ly)
    su = qtn.SimpleUpdate(psi0, ham, D=D, compute_energy_every=None,
                          compute_energy_final=False)
    for tau in (0.3, 0.1):
        su.evolve(nits, tau=tau)
    psi = su.get_state()
    arrays = []
    for i in range(Lx):
        for j in range(Ly):
            a = np.asarray(psi[i, j].transpose(*_urdlp(psi, i, j)).data,
                           dtype=np.float64)
            arrays.append(a / np.max(np.abs(a)))
    out["su_seconds"] = time.perf_counter() - t0
    out["arrays"] = [a.ravel().tolist() for a in arrays]
    out["shapes"] = [list(a.shape) for a in arrays]
    psi = qtn.PEPS([[arrays[i * Ly + j] for j in range(Ly)]
                    for i in range(Lx)], shape="urdlp")

    t0 = time.perf_counter()
    e_exact = {}
    for chi in (32, 64):
        e_exact[str(chi)] = float(np.real(psi.compute_local_expectation(
            ham.terms, max_bond=chi, normalized=True)))
    out["energy"] = e_exact
    out["energy_seconds"] = time.perf_counter() - t0

    H = heisenberg_from_edges(heisenberg_edges(Lx, Ly))
    configs = fixed_configs(Lx * Ly, nconf, VMC_SEEDS["configs"])
    out["configs"] = configs.tolist()
    vm = TNVMC(psi, H, nchains=nconf, learning_rate=0.05, sr_damping=1e-3)
    nparams = sum(int(np.prod(p.shape)) for p in vm.params)
    v = np.random.default_rng(VMC_SEEDS["v"]).standard_normal(nparams)
    cj = jnp.asarray(configs, dtype=jnp.int32)
    t0 = time.perf_counter()
    amps = np.asarray(vm._log_amp_batch(vm.params, cj))
    e_loc = np.asarray(vm._local_energies(vm.params, cj))
    O = np.asarray(vm._grad_logs(vm.params, cj))
    out["amps"] = amps.tolist()
    out["e_loc"] = np.real(e_loc).tolist()
    out["O_v"] = (O @ v).tolist()
    p_old = np.concatenate([np.asarray(p).ravel() for p in vm.params])
    vm._sample_batch = lambda params, n: cj
    e_mean, e_err = vm.step()
    p_new = np.concatenate([np.asarray(p).ravel() for p in vm.params])
    delta = (p_old - p_new) / vm.learning_rate
    out["step_energy"] = [float(e_mean), float(e_err)]
    out["delta_norm"] = float(np.linalg.norm(delta))
    out["delta_v"] = float(delta @ v)
    out["delta"] = delta.tolist()
    # the condition number of the SR matrix S = Om^T Om / n + damping:
    # two float64 solves of it agree to about cond * eps, not to eps
    Om = O - O.mean(axis=0)
    ev = np.linalg.eigvalsh(Om.T @ Om / nconf + 1e-3 * np.eye(nparams))
    out["S_cond"] = float(ev[-1] / ev[0])
    out["nparams"] = nparams
    out["vmc_seconds"] = time.perf_counter() - t0
    return out


def _urdlp(psi, i, j):
    """The index order u, r, d, l, p of site (i, j) that exists."""
    inds = []
    if i > 0:
        inds.append(psi.bond((i, j), (i - 1, j)))
    if j < psi.Ly - 1:
        inds.append(psi.bond((i, j), (i, j + 1)))
    if i < psi.Lx - 1:
        inds.append(psi.bond((i, j), (i + 1, j)))
    if j > 0:
        inds.append(psi.bond((i, j), (i, j - 1)))
    inds.append(psi.site_ind(i, j))
    return inds


def ctmrg(L=256, max_bond=32):
    from quimb_tpu.experimental.misc import (
        classical_ising_T_A_C,
        ctmrg_partition_function,
    )

    t0 = time.perf_counter()
    T, A, C = classical_ising_T_A_C(BETA_C)
    Z, exponent = ctmrg_partition_function(T, A, C, L, max_bond,
                                           strip_exponent=True)
    return {"L": L, "max_bond": max_bond, "beta": BETA_C,
            "log10_Z": float(np.log10(float(np.real(Z)))) + float(exponent),
            "seconds": time.perf_counter() - t0}


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    args = sys.argv[1:] or ["vmc", "ctmrg"]
    out_path = OUT
    if args and args[-1].endswith(".json"):
        out_path = args.pop()
    parts = {}
    if args[0] == "vmc" and len(args) > 1:
        Lx, Ly, D, nconf = (int(x) for x in args[1:5])
        parts["vmc"] = vmc(Lx, Ly, D, nconf, nits=4)
    else:
        for name in args:
            parts[name] = {"vmc": vmc, "ctmrg": ctmrg}[name]()
    old = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            old = json.load(f)
    old.update(parts)
    with open(out_path, "w") as f:
        json.dump(old, f)
    print(json.dumps({k: {kk: vv for kk, vv in v.items()
                          if not isinstance(vv, list)}
                      for k, v in parts.items()}))


if __name__ == "__main__":
    main()
