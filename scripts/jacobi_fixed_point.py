"""Does the Jacobi brickwork engine hold the DMRG2 fixed point? quimb_tpu's
``JacobiDMRG`` against the port's, from one converged state.

Two modes, each printing the energy's drift from the start state, read in
float64 on the host:

- ``cpu L chi``: on a CPU, quimb_tpu's DMRG2 (bond schedule 8, 16, chi,
  ``solve(tol=1e-9)``) gives the state; then three sweeps of each package's
  ``JacobiDMRG`` with ncv=2 and with ncv=8, the drift after the third::

      JAX_PLATFORMS=cpu python scripts/jacobi_fixed_point.py cpu 32 32

- ``card``: on a machine with a CUDA GPU (and JAX for the CPU), the
  float64 DMRG2 state of ``chip_smoke.py``'s phase 8 (L=128, chi=256, on
  the card); one sweep (two half-sweeps) of quimb_tpu's engine on the CPU
  and of the port's on the card from the same stacks, quimb_tpu's subspace
  starts passed to the port: each half-sweep's Ritz energies and the host
  energy after the sweep::

      python3 scripts/jacobi_fixed_point.py card
"""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def _jax():
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_platforms", "cpu")
    return jax


def cpu(L, chi):
    import torch

    _jax()
    import quimb_tpu.tensor as jtn
    from quimb_torch import convert
    from quimb_torch.tensor.tn1d import dmrg as tdm
    from quimb_torch.tensor.tn1d import dmrg_jacobi as tj
    from quimb_tpu.tensor.tn1d import dmrg_jacobi as jj

    H = jtn.MPO_ham_heis(L)
    d = jtn.DMRG2(H, bond_dims=[8, 16, chi], cutoffs=1e-10)
    d.solve(tol=1e-9, verbosity=0)
    e0 = float(d.energy)
    tH = convert.from_tpu_mpo(H, device="cpu")
    Ws = [W.numpy() for W in tdm._mpo_uniform_arrays(tH)]

    def energy(psi):
        env, nrm = np.ones((1, 1, 1)), np.ones((1, 1))
        for A, W in zip((A.numpy() for A in tdm._mps_uniform_arrays(psi)), Ws):
            env = np.einsum("bwk,kdx,wyud,bua->ayx", env, A, W, A.conj(),
                            optimize=True)
            nrm = np.einsum("bk,kdx,bda->ax", nrm, A, A.conj(), optimize=True)
        return float(env.reshape(())) / float(nrm.reshape(()))

    print(f"L={L}, chi={chi}: DMRG2 energy {e0!r}", flush=True)
    for ncv in (2, 8):
        jd = jj.JacobiDMRG(d.state, H, max_bond=chi, ncv=ncv)
        for _ in range(3):
            jd.sweep()
        td = tj.JacobiDMRG(convert.from_tpu_mps(d.state, device="cpu"), tH,
                           max_bond=chi, ncv=ncv)
        for _ in range(3):
            td.sweep()
        ej = energy(convert.from_tpu_mps(jd.get_state(), device="cpu"))
        et = energy(td.get_state())
        print(f"ncv={ncv}, three sweeps: quimb_tpu {ej - e0:+.3e}, port "
              f"{et - e0:+.3e}", flush=True)


def card():
    import torch

    import chip_smoke as cs
    from quimb_torch.tensor.tn1d import dmrg_jacobi as tj

    cs.check_device()
    cs.build_kernels()
    dmrg, _ = cs.run_main_path(torch.float64)
    H = dmrg.ham
    e0 = cs.host_f64_energy(dmrg.state, H)
    Ms = tj.mps_to_stack(dmrg.state, cs.CHI)
    Ws = tj.mpo_to_padded_stack(H).to(Ms.device)
    jax = _jax()
    import jax.numpy as jnp
    from quimb_tpu.tensor.tn1d import dmrg_jacobi as jj

    def energy(M):
        psi = tj.stack_to_mps(torch.as_tensor(np.asarray(M), device="cuda"),
                              dmrg.state)
        return cs.host_f64_energy(psi, H)

    kp = min(cs.CHI + 16, 2 * cs.CHI)
    for ncv in (2, 8):
        M_t, M_j = Ms, jnp.asarray(Ms.cpu().numpy())
        Wj = jnp.asarray(Ws.cpu().numpy())
        for parity in (0, 1):
            om = np.asarray(jax.random.normal(jax.random.PRNGKey(17 + parity),
                                              (2 * cs.CHI, kp), jnp.float64))
            t0 = time.perf_counter()
            M_j, e_j = jj._jacobi_halfsweep(M_j, Wj, parity=parity, ncv=ncv,
                                            max_bond=cs.CHI)
            M_j = jj._renormalize_stack(M_j)
            e_j = np.asarray(e_j)
            tj_s = time.perf_counter() - t0
            M_t, e_t = tj._jacobi_halfsweep(M_t, Ws, parity, ncv, cs.CHI,
                                            omega=om)
            M_t = tj._renormalize_stack(M_t)
            e_t = e_t.cpu().numpy()
            print(f"ncv={ncv} parity {parity}: mean Ritz energy quimb_tpu "
                  f"(CPU, {tj_s:.1f} s) {e_j.mean()!r}, port (card) "
                  f"{e_t.mean()!r}; largest Ritz distance "
                  f"{np.abs(e_j - e_t).max():.3e}", flush=True)
        print(f"ncv={ncv}, one sweep from {e0!r}: quimb_tpu "
              f"{energy(M_j) - e0:+.3e}, port {energy(M_t.cpu()) - e0:+.3e}",
              flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "cpu":
        cpu(int(sys.argv[2]), int(sys.argv[3]))
    else:
        card()
