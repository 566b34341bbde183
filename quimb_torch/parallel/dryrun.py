"""``dryrun_multichip``: one step of each sharded path on a world of ranks,
the counterpart of ``__graft_entry__.py:dryrun_multichip``."""

import numpy as np
import torch

from .mesh import _all_reduce, _init_mesh, mesh_device


def _circuit(n, device):
    from ..tensor.circuit import Circuit

    c = Circuit(n, device=device)
    for q in range(n):
        c.h(q)
    for q in range(n - 1):
        c.cx(q, q + 1)
    for q in range(n):
        c.rz(0.3 + 0.1 * q, q)
    for q in range(0, n - 1, 2):
        c.cz(q, q + 1)
    return c


def _amplitudes(params, vl, vr, configs):
    """<config|psi> of a chain of matrices, for a (B, L) batch."""
    env = vl.expand(configs.shape[0], -1)
    for i, A in enumerate(params):
        env = torch.einsum("bk,kbl->bl", env, A[:, configs[:, i], :])
    return env @ vr


def dryrun_multichip(n_devices, device=None):
    """Run one step of each sharded path on a ``dp x tp`` mesh of the
    world's ``n_devices`` ranks (``(n / 2, 2)``, or ``(n, 1)`` for odd
    ``n``), at tiny shapes, and check it:

    - a variational training step: the batch of configurations split over
      ``dp``, each rank's loss and its gradient (``torch.autograd``)
      averaged over ``dp`` by an all-reduce, then an SGD step;
    - a matvec with its columns split over ``tp`` and summed by an
      all-reduce, against the dense one;
    - one ``shard_onto`` DMRG2 sweep at L=16, chi=8 on the same mesh;
    - sliced sampling and a marginal of a 6-qubit circuit through
      ``mesh=``, the marginal against the unsharded one.

    ``n_devices`` must be the world's size (a one-rank world is started
    when there is none). The ranks are on the card unless ``device`` is
    given. Returns the checked numbers."""
    from ..tensor.tn1d.builders import MPO_ham_heis, MPS_rand_state
    from ..tensor.tn1d.dmrg import DMRG2

    shape = (n_devices // 2, 2) if n_devices % 2 == 0 else (n_devices, 1)
    mesh = _init_mesh(shape, ("dp", "tp"), device)
    dev = mesh_device(mesh)
    dp, tp = mesh.get_group("dp"), mesh.get_group("tp")
    ndp, ntp = shape
    cdp, ctp = mesh.get_local_rank("dp"), mesh.get_local_rank("tp")

    L_sites, chi, d = 6, 4, 2
    rng = np.random.default_rng(0)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    params = [f32(rng.standard_normal((chi, d, chi)) * 0.3)
              for _ in range(L_sites)]
    vl = f32(rng.standard_normal((chi,)))
    vr = f32(rng.standard_normal((chi,)))
    B = 4 * max(ndp, 1)
    configs = torch.tensor(rng.integers(0, d, (B, L_sites)), device=dev)
    D = 64
    H = f32(rng.standard_normal((D, D)) * 0.1)
    H = (H + H.T) / 2
    x = f32(rng.standard_normal((D,)))

    # dp: this rank's rows of the batch, its loss and gradient averaged
    rows = slice(cdp * B // ndp, (cdp + 1) * B // ndp)
    leaves = [p.clone().requires_grad_() for p in params]
    amps = _amplitudes(leaves, vl, vr, configs[rows])
    loss = -torch.mean(torch.log(amps ** 2 + 1e-12))
    grads = torch.autograd.grad(loss, leaves)
    loss = _all_reduce(loss.detach().clone(), dp) / ndp
    grads = [_all_reduce(g.clone(), dp) / ndp for g in grads]
    # tp: the contraction dimension of the matvec split over the ranks
    cols = slice(ctp * D // ntp, (ctp + 1) * D // ntp)
    y = _all_reduce(H[:, cols] @ x[cols], tp)
    new_params = [p - 0.01 * g for p, g in zip(params, grads)]

    np.testing.assert_allclose(y.cpu().numpy(), (H @ x).cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    if not (bool(torch.isfinite(loss))
            and all(bool(torch.isfinite(p).all()) for p in new_params)):
        raise AssertionError("the sharded training step is not finite")

    # the sharded DMRG2 sweep on the same mesh
    Ld, chid = 16, 8
    dmrg = DMRG2(MPO_ham_heis(Ld, device=dev), bond_dims=chid, cutoffs=0.0,
                 p0=MPS_rand_state(Ld, chid, seed=2, dtype=torch.float32,
                                   device=dev))
    dmrg.shard_onto(mesh, axes=("dp", "tp"))
    en = dmrg.sweep("R", max_bond=chid, cutoff=0.0)
    if not np.isfinite(en):
        raise AssertionError("the sharded DMRG2 sweep is not finite")

    # sliced circuit sampling and a marginal across the mesh
    samples = list(_circuit(6, dev).sample(4, seed=7, mesh=mesh))
    if not (len(samples) == 4 and all(len(s) == 6 for s in samples)):
        raise AssertionError(f"bad samples {samples}")
    p_mesh = np.asarray(_circuit(6, dev).compute_marginal(
        (0, 1), mesh=mesh)).reshape(-1)
    p_ser = np.asarray(_circuit(6, dev).compute_marginal((0, 1))).reshape(-1)
    np.testing.assert_allclose(p_mesh, p_ser, rtol=2e-4, atol=2e-5)

    print(f"dryrun_multichip ok: mesh={shape} loss={float(loss):.4f}"
          f" dmrg_sweep_energy={en:.4f}"
          f" sliced_sampling_marginal_maxdiff="
          f"{float(np.abs(p_mesh - p_ser).max()):.2e}", flush=True)
    return {"mesh": shape, "loss": float(loss), "y": y.cpu().numpy(),
            "dmrg_energy": en, "samples": samples, "p_mesh": p_mesh,
            "p_ser": p_ser}
