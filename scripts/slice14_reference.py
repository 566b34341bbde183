"""Record quimb_tpu's float64 values of the optimisation and fitting phases
that ``chip_smoke.py`` holds the port to (phases 24(a)-(c)).

Four parts, each written under its name into
``scripts/slice14_reference.json`` (the other parts' entries are kept):

- ``optimizer``: phase 24(b). An L=128, chi=256 MPS whose arrays are
  standard normal draws of ``np.random.default_rng(42)`` in the shapes of
  ``MPS_rand_state`` (site by site, each array ``(l, r, p)``), normalised
  site by site on the host (:func:`start_arrays`). The loss is the
  Rayleigh quotient <psi|H|psi> / <psi|psi> of ``MPO_ham_heis(128)``,
  contracted site by site in the chi^3 order of :func:`rayleigh_quotient`.
  ``TNOptimizer`` runs 3 L-BFGS-B iterations, then, from the start arrays
  again, 3 Adam steps at learning rate 0.01: each loss evaluation is
  recorded.
- ``cluster``: phase 24(c). ``ClusterUpdateGen`` (cluster_distance 1) on
  phase 21(a)'s kagome model (the open 6 x 6 lattice, 108 sites, D=4,
  start arrays from ``default_rng(42)``) at tau 0.3, and after each of
  its first ``CLUSTER_STEPS`` steps the energy per site by phase 21(a)'s
  estimator (``gauge_all_simple(max_iterations=20)``, then
  ``compute_local_expectation(method="cluster")``).
- ``compress``: the rehearsal of phase 24(a) at L=32, chi=64. A DMRG2
  ground state of ``MPO_ham_heis(32)`` (quimb_tpu, bonds 16, 32, 64, 64),
  H|psi> (bond 320) compressed back to 64 at cutoff 1e-10 by each method
  through ``tensor_network_1d_compress``, in quimb_tpu and in quimb_torch on the
  CPU from the same arrays; each infidelity 1 - F against the uncompressed
  H|psi>, from exact host overlaps (:func:`overlap`).
- ``spectral``: the rehearsal of phase 25 on the same kind of matrix: the
  reduced density matrix of the 10-site middle block of that L=32 state
  (quimb_tpu's ``partial_trace``, 1024 x 1024), the largest distance of
  quimb_tpu's ``rsvd(rho, 16, p=8)`` singular values from numpy's SVD
  (relative to the largest), and quimb_tpu's SLQ estimate of
  Tr rho log2 rho (seed 7, tol 0.05, R_min 256) beside the exact value.

JAX runs on the CPU in float64. Run from the root of the repository::

    JAX_PLATFORMS=cpu python scripts/slice14_reference.py [optimizer] \\
        [cluster] [compress] [spectral]

(each part may run in a process of its own: the file is re-read and
merged before every write).
"""

import json
import os
import sys
import time

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "slice14_reference.json")
PARTS = ("optimizer", "cluster", "compress", "spectral")

OPT_L, OPT_CHI, OPT_SEED = 128, 256, 42
OPT_LBFGS_ITS, OPT_ADAM_STEPS, OPT_ADAM_LR = 3, 3, 0.01
KAGOME_L, KAGOME_D, CLUSTER_TAU, CLUSTER_STEPS = 6, 4, 0.3, 4
KAGOME_GAUGE_ITERATIONS = 20
REHEARSAL_L, REHEARSAL_CHI = 32, 64
COMPRESS_METHODS = ("dm", "fit", "src-oversample", "projector", "bidm")
# the dispatcher's default cutoff: at cutoff 0 bidm keeps rounding-level
# singular values and divides by their square roots (on an H100 that
# spoiled the north-star compression, infidelity 0.91)
COMPRESS_CUTOFF = 1e-10
BLOCK, RSVD_K, RSVD_P = 10, 16, 8
SLQ_SEED, SLQ_TOL, SLQ_R_MIN = 7, 0.05, 256


def start_arrays(L, chi, seed, phys_dim=2):
    """The (l, r, p) arrays of an open MPS (edge arrays (1, r, p) and
    (l, 1, p)), standard normal draws of ``default_rng(seed)`` in the
    shapes of ``MPS_rand_state``, each scaled so that the left norm
    environment after its site has unit trace (so <psi|psi> = 1, and no
    partial environment under- or overflows)."""
    rng = np.random.default_rng(seed)
    arrays = []
    env = np.ones((1, 1))
    for i in range(L):
        chil = min(chi, phys_dim**i, phys_dim**(L - i))
        chir = min(chi, phys_dim**(i + 1), phys_dim**(L - i - 1))
        A = rng.standard_normal((chil, chir, phys_dim))
        new = np.tensordot(np.tensordot(env, A, (0, 0)), A, ((0, 2), (0, 2)))
        A = A / np.sqrt(np.trace(new))
        env = new / np.trace(new)
        arrays.append(A)
    return arrays


def squeeze_edges(arrays):
    """(1, r, p) and (l, 1, p) edge arrays as (r, p) and (l, p)."""
    return [arrays[0][0]] + list(arrays[1:-1]) + [arrays[-1][:, 0]]


def _rq_site(xp, env, nrm, A, W):
    """One site of the Rayleigh quotient's sweep. Both environments are
    divided by the norm environment's Frobenius norm, which leaves the
    quotient as it is and keeps its numerator and denominator near 1:
    Adam grows the parameters, and once <psi|psi> passed about 1e154 JAX's
    gradient of a quotient (its square of the denominator) overflowed to
    0 while torch's did not."""
    T = xp.einsum("awb,brp->awrp", env, A)
    T = xp.einsum("awrp,wxqp->axrq", T, W)
    env = xp.einsum("axrq,asq->sxr", T, A.conj())
    n = xp.einsum("ab,brp->arp", nrm, A)
    nrm = xp.einsum("arp,asp->sr", n, A.conj())
    c = xp.linalg.norm(nrm)
    return env / c, nrm / c


def rayleigh_quotient(As, Ws, xp):
    """<psi|H|psi> / <psi|psi> from (l, r, p) MPS arrays and (wl, wr, u, d)
    MPO arrays (edges padded to size-1 bonds), site by site: chi^3 w d
    operations a site, in the same order in numpy, jax.numpy and torch.
    In jax.numpy the bulk sites of one shape run as one ``lax.scan`` (the
    same einsums a site), so that the jitted gradient compiles in seconds
    rather than tracing 128 unrolled sites."""
    env = xp.ones((1, 1, 1), dtype=As[0].dtype)
    nrm = xp.ones((1, 1), dtype=As[0].dtype)
    i, L = 0, len(As)
    while i < L:
        j = i
        if xp.__name__ == "jax.numpy":
            while (j + 1 < L and As[j + 1].shape == As[i].shape
                   and Ws[j + 1].shape == Ws[i].shape):
                j += 1
        if j - i >= 2:
            import jax

            def body(carry, AW):
                return _rq_site(xp, *carry, *AW), None

            (env, nrm), _ = jax.lax.scan(
                body, (env, nrm), (xp.stack(As[i:j + 1]),
                                   xp.stack(Ws[i:j + 1])))
            i = j + 1
        else:
            env, nrm = _rq_site(xp, env, nrm, As[i], Ws[i])
            i += 1
    return (env.reshape(()) / nrm.reshape(())).real


def overlap(As, Bs, Ws=None):
    """<B|W|A> (or <B|A>) of host (l, r, p) arrays (MPO (wl, wr, u, d)),
    edges padded, by one site sweep in float64."""
    env = np.ones((1, 1, 1))
    for i, (A, B) in enumerate(zip(As, Bs)):
        W = (np.eye(A.shape[2])[None, None] if Ws is None else Ws[i])
        T = np.einsum("awb,brp->awrp", env, A)
        T = np.einsum("awrp,wxqp->axrq", T, W)
        env = np.einsum("axrq,asq->sxr", T, B.conj())
    return complex(env.reshape(()))


def _padded_mpo(H):
    Ws = [np.asarray(t.data) for t in H]
    return [Ws[0][None]] + Ws[1:-1] + [Ws[-1][:, None]]


def optimizer():
    import jax.numpy as jnp

    import quimb_tpu.tensor as qtn

    H = qtn.MPO_ham_heis(OPT_L)
    Ws = [jnp.asarray(w) for w in _padded_mpo(H)]
    arrays = squeeze_edges(start_arrays(OPT_L, OPT_CHI, OPT_SEED))
    psi = qtn.MatrixProductState([jnp.asarray(a) for a in arrays],
                                 shape="lrp")

    def loss(psi):
        As = [psi[psi.site_tag(i)].data for i in range(psi.L)]
        As = [As[0][None]] + As[1:-1] + [As[-1][:, None]]
        return rayleigh_quotient(As, Ws, jnp)

    out = {"L": OPT_L, "chi": OPT_CHI, "seed": OPT_SEED}
    for name, n, kw in (("lbfgsb", OPT_LBFGS_ITS, {}),
                        ("adam", OPT_ADAM_STEPS,
                         dict(optimizer="adam",
                              learning_rate=OPT_ADAM_LR))):
        t0 = time.perf_counter()
        opt = qtn.TNOptimizer(psi, loss, progbar=False, **kw)
        opt.optimize(n)
        out[name] = {"losses": [float(v) for v in opt.losses],
                     "iterations": n,
                     "seconds": time.perf_counter() - t0}
        print(name, out[name], flush=True)
    return out


def cluster():
    import quimb_tpu.experimental as qex
    import quimb_tpu.tensor as qtn

    t0 = time.perf_counter()
    edges = qtn.edges_2d_kagome(KAGOME_L, KAGOME_L)
    rng = np.random.default_rng(42)
    psi0 = qtn.TN_from_edges_and_fill_fn(
        lambda shape: rng.standard_normal(shape), edges, KAGOME_D,
        phys_dim=2)
    ham = qtn.ham_gen_heis(edges)
    su = qex.ClusterUpdateGen(psi0, ham, D=KAGOME_D, cluster_distance=1,
                              compute_energy_final=False)
    energies, seconds = [], []
    for _ in range(CLUSTER_STEPS):
        ts = time.perf_counter()
        su.evolve(1, tau=CLUSTER_TAU)
        seconds.append(time.perf_counter() - ts)
        gauges = {}
        tn = su.get_state().gauge_all_simple(
            max_iterations=KAGOME_GAUGE_ITERATIONS, gauges=gauges)
        e = tn.compute_local_expectation(ham.terms, method="cluster",
                                         gauges=gauges)
        energies.append(float(np.real(e)) / psi0.nsites)
        print("cluster step", len(energies), energies[-1], seconds[-1],
              flush=True)
    return {"L": KAGOME_L, "D": KAGOME_D, "tau": CLUSTER_TAU,
            "cluster_distance": 1,
            "gauge_iterations": KAGOME_GAUGE_ITERATIONS,
            "sites": psi0.nsites, "bonds": len(edges),
            "energy_per_site": energies, "step_seconds": seconds,
            "seconds": time.perf_counter() - t0}


def _chain_arrays(tn, L, site_tag, site_ind):
    """The (l, r, p) arrays (edges padded) of a one-tensor-per-site
    network, as host arrays, whichever package made it."""
    ts = [tn[site_tag(i)] for i in range(L)]
    out = []
    for i, t in enumerate(ts):
        lb = [ix for ix in t.inds if i > 0 and ix in ts[i - 1].inds]
        rb = [ix for ix in t.inds if i < L - 1 and ix in ts[i + 1].inds]
        data = np.asarray(t.transpose(*lb, *rb, site_ind(i)).data)
        out.append(data.reshape(max(1, data.shape[0] if lb else 1),
                                -1, data.shape[-1]))
    return out


def _infidelity(As, Ws, Bs):
    """1 - |<B|H A>|^2 / (<B|B> <HA|HA>)."""
    hab = overlap(As, Bs, Ws)
    bb = overlap(Bs, Bs).real
    env = np.ones((1, 1, 1, 1))
    for A, W in zip(As, Ws):
        T = np.einsum("avwb,brp->avwrp", env, A)
        T = np.einsum("avwrp,wyqp->avyrq", T, W)
        T = np.einsum("avyrq,vxcq->axyrc", T, W.conj())
        env = np.einsum("axyrc,asc->sxyr", T, A.conj())
    hh = complex(env.reshape(())).real
    return 1 - abs(hab) ** 2 / (bb * hh)


def compress():
    import jax.numpy as jnp
    import torch

    import quimb_torch.tensor as ttn
    import quimb_tpu.tensor as qtn
    from quimb_torch.tensor.tn1d import compress as tcomp
    from quimb_tpu.tensor.tn1d import compress as jcomp

    t0 = time.perf_counter()
    L, chi = REHEARSAL_L, REHEARSAL_CHI
    H = qtn.MPO_ham_heis(L)
    dmrg = qtn.DMRG2(H, bond_dims=[16, 32, 64, 64], cutoffs=1e-14)
    dmrg.solve(max_sweeps=4, tol=1e-10, verbosity=0)
    psi = dmrg.state
    As = _chain_arrays(psi, L, psi.site_tag, psi.site_ind)
    Ws = _padded_mpo(H)
    jpsi = qtn.MatrixProductState(
        [jnp.asarray(a) for a in squeeze_edges(As)], shape="lrp")
    tpsi = ttn.MatrixProductState(
        [torch.as_tensor(a) for a in squeeze_edges(As)], shape="lrp")
    tH = ttn.MatrixProductOperator(
        [torch.as_tensor(np.asarray(t.data)) for t in H])
    out = {"L": L, "chi": chi, "cutoff": COMPRESS_CUTOFF,
           "energy": float(dmrg.energy),
           "quimb_tpu": {}, "quimb_torch": {}, "seconds": {}}
    for method in COMPRESS_METHODS:
        for name, comp, st, Hx in (("quimb_tpu", jcomp, jpsi, H),
                                   ("quimb_torch", tcomp, tpsi, tH)):
            ts = time.perf_counter()
            tn = comp._lazy_mpo_mps_tn(Hx, st)
            c = comp.tensor_network_1d_compress(
                tn, max_bond=chi, cutoff=COMPRESS_CUTOFF, method=method,
                site_tags=[st.site_tag(i) for i in range(L)],
                **({"seed": 7} if method.startswith("src") else {}))
            Bs = _chain_arrays(c, L, st.site_tag, Hx.upper_ind)
            out[name][method] = _infidelity(As, Ws, Bs)
            out["seconds"][f"{name} {method}"] = time.perf_counter() - ts
            print(name, method, out[name][method], flush=True)
    out["total_seconds"] = time.perf_counter() - t0
    out["arrays_note"] = "DMRG2 state of quimb_tpu, bonds 16, 32, 64, 64"
    return out


def spectral():
    import quimb_tpu.tensor as qtn
    from quimb_tpu.linalg import approx_spectral as jas
    from quimb_tpu.linalg.rand_linalg import rsvd

    t0 = time.perf_counter()
    L = REHEARSAL_L
    H = qtn.MPO_ham_heis(L)
    dmrg = qtn.DMRG2(H, bond_dims=[16, 32, 64, 64], cutoffs=1e-14)
    dmrg.solve(max_sweeps=4, tol=1e-10, verbosity=0)
    start = L // 2 - BLOCK // 2
    rho = np.array(dmrg.state.partial_trace(range(start, start + BLOCK)))
    rho = (rho + rho.conj().T) / 2
    s = np.linalg.svd(rho, compute_uv=False)
    sk = np.asarray(rsvd(rho, RSVD_K, p=RSVD_P, compute_uv=False))
    w = np.clip(np.linalg.eigvalsh(rho), 0, None)
    exact = float(np.sum(jas.xlogx(w)))
    est = jas.tr_xlogx_approx(rho, seed=SLQ_SEED, tol=SLQ_TOL,
                              R_min=SLQ_R_MIN)
    return {"L": L, "block": BLOCK, "k": RSVD_K, "p": RSVD_P,
            "rsvd_max_rel": float(np.max(np.abs(sk - s[:RSVD_K])) / s[0]),
            "s_top": s[:RSVD_K].tolist(), "xlogx_exact": exact,
            "xlogx_slq": est, "slq_seed": SLQ_SEED, "slq_tol": SLQ_TOL,
            "slq_R_min": SLQ_R_MIN, "seconds": time.perf_counter() - t0}


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    for part in sys.argv[1:] or PARTS:
        if part not in PARTS:
            raise ValueError(f"unknown part {part!r}")
        done = globals()[part]()
        now = json.load(open(OUT)) if os.path.exists(OUT) else {}
        now[part] = done
        with open(OUT, "w") as f:
            json.dump(now, f, indent=1)
        print(json.dumps({part: done}), flush=True)


if __name__ == "__main__":
    main()
