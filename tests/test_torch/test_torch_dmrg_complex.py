"""quimb_torch's DMRG2, DMRG1 and ParallelDMRG with complex128 operands,
against quimb_tpu's, on the CPU.

The Hamiltonian is the Heisenberg chain with every site's operator space
turned by a fixed random unitary, ``H' = V H V^dagger`` with ``V`` a
product of one-site unitaries: its spectrum is the chain's, and its MPO
and states are genuinely complex, so a missing conjugation or a real cast
shows. Both packages sweep the same start states; the port's subspace
splits take quimb_tpu's random starts (``decomp._random_start``
patched). On CUDA a complex sweep takes the plain product, by the dtype
rule of ``cuda_kernels.resolve_sandwich``, as quimb_tpu's
``use_sandwich_kernel`` does; the card's runs are in
``test_torch_cuda.py``.
"""

import functools

import numpy as np
import pytest
import torch

import quimb_tpu.tensor as qtn
import quimb_torch
from quimb_torch.convert import from_tpu_mpo, from_tpu_mps
from quimb_torch.ops import cuda_kernels as ck
from quimb_torch.ops import decomp as tdecomp
from quimb_tpu.tensor.tn1d import dmrg_parallel as jp
from quimb_torch.tensor.tn1d import dmrg_parallel as tp

from .test_torch_dmrg import E_EXACT_L10
from .test_torch_dmrg_parallel import _uniform
from .test_torch_split import jax_random_start


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the tests run beside others on a shared host, where
    torch's default of a thread per core oversubscribes it (a sweep here
    took 143 s under six test workers against 19 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host_energy(psi, H):
    """<psi|H|psi>/<psi|psi> of an MPS of either package under an MPO, in
    complex128 numpy; the real part."""
    env, nrm = np.ones((1, 1, 1)), np.ones((1, 1))
    for A, W in zip(_uniform(psi), _uniform(H)):
        A, W = (np.asarray(x.resolve_conj().numpy()
                           if isinstance(x, torch.Tensor) else x)
                for x in (A, W))
        env = np.einsum("bwk,kdx,wyud,bua->ayx", env, A, W, A.conj(),
                        optimize=True)
        nrm = np.einsum("bk,kdx,bda->ax", nrm, A, A.conj(), optimize=True)
    return float((env.reshape(()) / nrm.reshape(())).real)


def _site_unitaries(L, seed=4):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(L, 2, 2)) + 1j * rng.normal(size=(L, 2, 2))
    return [np.linalg.qr(zi)[0] for zi in z]


@functools.lru_cache(maxsize=None)
def _rotated_heis(L):
    """quimb_tpu's complex128 Heisenberg MPO turned site by site by
    :func:`_site_unitaries`."""
    import jax.numpy as jnp

    H = qtn.MPO_ham_heis(L, dtype="complex128")
    for i, U in enumerate(_site_unitaries(L)):
        t = H[H.site_tag(i)]
        u, d = t.inds.index(H.upper_ind(i)), t.inds.index(H.lower_ind(i))
        a = np.moveaxis(np.asarray(t.data), (u, d), (-2, -1))
        a = U @ a @ U.conj().T
        t.modify(data=jnp.asarray(np.moveaxis(a, (-2, -1), (u, d))))
    return H


def _start(L, chi, seed):
    return qtn.MPS_rand_state(L, chi, seed=seed, dtype="complex128")


def _pair(cls, H, psi, chi, cutoff):
    j = getattr(qtn, cls)(H, bond_dims=chi, cutoffs=cutoff, p0=psi)
    t = getattr(quimb_torch, cls)(from_tpu_mpo(H, device="cpu"),
                                  bond_dims=chi, cutoffs=cutoff,
                                  p0=from_tpu_mps(psi, device="cpu"))
    assert t._sandwich is ck.prepare_sandwich_reference
    assert t._A[0].dtype == torch.complex128
    return j, t


@pytest.mark.parametrize("method,cutoff", [("svd", 1e-10),
                                           ("svd:sub", 1e-10),
                                           ("svd:sub", 0.0)])
def test_dmrg2_complex_matches(monkeypatch, method, cutoff):
    """Four DMRG2 sweeps (R, L, R, L) at L=10, chi=8 (every bulk bond
    truncates 16 values to 8) from one complex start. With a cutoff the
    splits are SVDs, or subspace iterations from quimb_tpu's start: the
    energies agree to 1e-9 (float64 round-off through 36 truncating
    splits). "svd:sub" at cutoff 0 is the pure subspace split, whose two
    iterations depend on the bond basis, and a complex basis carries a
    phase per column from each package's eigh and QR: the two take
    different near-optimal truncations (1e-4 apart after the first
    sweep), and agree to 1e-6 after four."""
    monkeypatch.setattr(tdecomp, "_random_start", jax_random_start)
    monkeypatch.delenv("QUIMB_TPU_SUB0_OVERSAMPLE", raising=False)
    j, t = _pair("DMRG2", _rotated_heis(10), _start(10, 8, seed=3), 8,
                 cutoff)
    for dmrg in (j, t):
        dmrg.opts["bond_compress_method"] = method
    for direction, canonize in [("R", True), ("L", False), ("R", False),
                                ("L", False)]:
        kw = dict(max_bond=8, cutoff=cutoff, canonize=canonize)
        j_en, t_en = j.sweep(direction, **kw), t.sweep(direction, **kw)
        if cutoff:
            assert abs(t_en - j_en) < 1e-9
    assert abs(t_en - j_en) < 1e-6
    psi = t.state
    assert psi.dtype == torch.complex128
    assert abs(_host_energy(psi, t.ham) - t_en) < 1e-6


def test_dmrg2_complex_reaches_the_ground_energy():
    """The port alone: DMRG2 of the turned chain at chi=32 reaches the
    chain's exact ground energy (a converged float64 sweep: 1e-9), in a
    state whose tensors are genuinely complex."""
    H = from_tpu_mpo(_rotated_heis(10), device="cpu")
    dmrg = quimb_torch.DMRG2(H, bond_dims=[8, 16, 32], cutoffs=1e-12,
                             p0=from_tpu_mps(_start(10, 8, seed=5),
                                             device="cpu"))
    assert dmrg.solve(tol=1e-11, max_sweeps=12)
    assert abs(dmrg.energy - E_EXACT_L10) < 1e-9
    psi = dmrg.state
    assert abs(_host_energy(psi, H) - E_EXACT_L10) < 1e-9
    imag = max(float(torch.abs(t.data.imag).max()) for t in psi)
    assert imag > 1e-2


def test_dmrg1_complex_matches():
    """DMRG1 (Lanczos bases of 4 vectors, the one-site space at a chain
    end, see ``test_torch_dmrg1.py``) from a complex state one DMRG2
    sweep from random, at a fixed chi=8: the sweeps' energies agree to
    1e-9 (float64 round-off)."""
    H = _rotated_heis(10)
    d2 = qtn.DMRG2(H, bond_dims=8, cutoffs=1e-10, p0=_start(10, 8, seed=7))
    d2.sweep("R", max_bond=8, cutoff=1e-10)
    j, t = _pair("DMRG1", H, d2.state, 8, 1e-10)
    for dmrg in (j, t):
        dmrg.opts["local_eig_ncv"] = 2
        dmrg.opts["local_eig_ncv_floor"] = 4
    for direction, canonize in [("R", True), ("L", False), ("R", False)]:
        kw = dict(max_bond=8, cutoff=1e-10, canonize=canonize)
        j_en, t_en = j.sweep(direction, **kw), t.sweep(direction, **kw)
        assert abs(t_en - j_en) < 1e-9


def test_parallel_dmrg_complex_matches(monkeypatch):
    """Three outer sweeps of ParallelDMRG (S=2) at L=16, chi=12 from a
    complex state one DMRG2 sweep from random, with quimb_tpu's random
    starts. The batched split iterates twice on a subspace in a bond
    basis whose column phases come from each package's complex eigh and
    QR (as "svd:sub0" does), so the kept subspaces differ by round-off
    amplified through the sweeps: the energies agree to 1e-6 (7e-8 seen),
    the real sweeps' test holds 1e-8."""
    monkeypatch.setattr(tdecomp, "_random_start", jax_random_start)
    monkeypatch.delenv("QUIMB_TPU_PAR_PALLAS", raising=False)
    L, chi = 16, 12
    H = _rotated_heis(L)
    seed = qtn.DMRG2(H, bond_dims=8, cutoffs=1e-10, p0=_start(L, 8, 35))
    seed.sweep("R", max_bond=8, cutoff=1e-10)
    jpd = jp.ParallelDMRG(seed.state, H, max_bond=chi, n_segments=2)
    tpd = tp.ParallelDMRG(from_tpu_mps(seed.state, device="cpu"),
                          from_tpu_mpo(H, device="cpu"), max_bond=chi,
                          n_segments=2)
    assert tpd.Ms.dtype == torch.complex128
    assert tpd._sandwich is ck.prepare_sandwich_reference
    for _ in range(3):
        assert abs(tpd.sweep() - jpd.sweep()) < 1e-6
    want = _host_energy(jpd.get_state(), H)
    assert abs(_host_energy(tpd.get_state(), H) - want) < 1e-6
