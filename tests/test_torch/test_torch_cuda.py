"""quimb_torch on a CUDA GPU: the hand-written sandwich kernels (3xTF32
for float32, FP64 tensor cores for float64) against their plain version,
and small DMRG2, DMRG1, ParallelDMRG and TEBD runs against the CPU
port.

Every test here needs a GPU and skips without one. The file imports no
JAX; on a GPU machine run it without the JAX setup of the test
configuration, from the root of the repository::

    python -m pytest tests/test_torch/test_torch_cuda.py -p no:cacheprovider --noconftest
"""

import numpy as np
import pytest
import torch

import quimb_torch
from quimb_torch.ops import cuda_kernels as ck

pytestmark = pytest.mark.cuda

# (w, M, K1, K2, N): the bulk bond at chi=256, the 1-site (DMRG1) bond,
# bonds next to a chain end, a ragged shape (K1 and N no multiple of 4),
# a small odd one and 1 x 1 bonds
SHAPES = [(5, 512, 512, 512, 512), (5, 512, 512, 256, 256),
          (5, 4, 4, 512, 512), (5, 2, 2, 512, 512), (5, 130, 66, 98, 34),
          (3, 7, 5, 9, 3), (1, 1, 1, 1, 1)]
_KERNEL = {torch.float32: "sandwich_tf32", torch.float64: "sandwich_f64"}


def _host_operands(shape, seed=0):
    w, M, K1, K2, N = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((w, M, K1)), rng.standard_normal((K1, K2)),
            rng.standard_normal((w, K2, N)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_kernel_matches_plain(cuda, shape, dtype, tol):
    w, M, K1, K2, N = shape
    host = _host_operands(shape)
    ref = ck.sandwich_matvec_reference(
        *(torch.as_tensor(x, device=cuda) for x in host))
    before = dict(ck.LAUNCHES)
    got = ck.sandwich_matvec(
        *(torch.as_tensor(x, dtype=dtype, device=cuda) for x in host))
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {**before, _KERNEL[dtype]: before[_KERNEL[dtype]]
                           + 1}
    assert got.dtype == dtype and got.shape == (M, N)
    # relative Frobenius error against float64: float32 sums over depths
    # up to 5 * 512 in 3xTF32, float64 ones on the FP64 tensor cores
    rel = torch.linalg.norm(got.double() - ref) / torch.linalg.norm(ref)
    assert rel.item() <= tol


@pytest.mark.parametrize("shape", SHAPES[:5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_bitwise_repeatable(cuda, shape, dtype):
    """No atomics: the same operands give the same bits, whether prepared
    once and applied twice or prepared anew."""
    a, theta, b = (torch.as_tensor(x, dtype=dtype, device=cuda)
                   for x in _host_operands(shape, seed=1))
    heff = ck.resolve_sandwich(cuda, dtype)(a, b)
    first, second = heff(theta), heff(theta)
    one_shot = ck.sandwich_matvec(a, theta, b)
    assert torch.equal(first, second)
    assert torch.equal(first, one_shot)


def test_prepared_applies_many_thetas(cuda):
    """One prepared operand set applied to several theta, back to back on
    one stream (its scratch is reused), gives the one-shot results."""
    shape = (5, 130, 66, 98, 34)
    a, _, b = (torch.as_tensor(x, dtype=torch.float32, device=cuda)
               for x in _host_operands(shape, seed=2))
    rng = np.random.default_rng(3)
    thetas = [torch.as_tensor(rng.standard_normal((66, 98)),
                              dtype=torch.float32, device=cuda)
              for _ in range(4)]
    heff = ck.prepare_sandwich(a, b)
    outs = [heff(th) for th in thetas]
    for th, out in zip(thetas, outs):
        assert torch.equal(out, ck.sandwich_matvec(a, th, b))


def test_kernel_rejects(cuda):
    a = torch.ones((2, 3, 3), device=cuda)
    th = torch.ones((3, 4), device=cuda)
    b = torch.ones((2, 4, 5), device=cuda)
    with pytest.raises(NotImplementedError):
        ck.sandwich_matvec(a.to(torch.complex64), th.to(torch.complex64),
                           b.to(torch.complex64))
    with pytest.raises(ValueError):
        ck.sandwich_matvec(a, th.T.contiguous().T, b)
    with pytest.raises(ValueError):
        ck.sandwich_matvec(a, th[:2], b)
    with pytest.raises(ValueError):
        ck.sandwich_matvec(a, th.cpu(), b)


def test_dmrg_matches_cpu(cuda):
    """A float64 DMRG2 run through the kernel gives the CPU port's
    energies (the plain einsum there)."""
    energies = {}
    for device in ("cpu", cuda):
        H = quimb_torch.MPO_ham_heis(16, device=device)
        p0 = quimb_torch.MPS_rand_state(16, 8, seed=1, device=device)
        dmrg = quimb_torch.DMRG2(H, bond_dims=16, cutoffs=0.0, p0=p0)
        energies[str(device)] = [
            dmrg.sweep(d, max_bond=16, cutoff=0.0, canonize=d == "R")
            for d in "RLRL"
        ]
    # float64 on both; the sums run in other orders
    np.testing.assert_allclose(energies["cuda"], energies["cpu"],
                               rtol=1e-10)


def test_dmrg_float32_through_tf32_kernel(cuda):
    """A float32 DMRG2 run on the card goes through the 3xTF32 kernel at
    every matvec and follows the float64 CPU run's energies."""
    energies = {}
    for device, dtype in (("cpu", torch.float64), (cuda, torch.float32)):
        H = quimb_torch.MPO_ham_heis(16, dtype=dtype, device=device)
        p0 = quimb_torch.MPS_rand_state(16, 8, seed=1, dtype=dtype,
                                        device=device)
        dmrg = quimb_torch.DMRG2(H, bond_dims=16, cutoffs=0.0, p0=p0)
        before = dict(ck.LAUNCHES)
        energies[str(device)] = [
            dmrg.sweep(d, max_bond=16, cutoff=0.0, canonize=d == "R")
            for d in "RLRL"
        ]
        if dtype == torch.float32:
            n = ck.LAUNCHES["sandwich_tf32"] - before["sandwich_tf32"]
            assert n >= 4 * 8 * 15
            assert ck.LAUNCHES["sandwich_f64"] == before["sandwich_f64"]
    # the converged sweeps of a float32 state against float64 agree to
    # the float32 bound of chip_smoke.py's main path (the first sweeps,
    # from a random state, follow other float32 and float64 paths)
    np.testing.assert_allclose(energies["cuda"][-2:], energies["cpu"][-2:],
                               rtol=2e-5)


def test_dmrg_float64_through_dmma_kernel(cuda):
    """A float64 DMRG2 run on the card goes through the FP64 tensor-core
    kernel at every matvec, never through the float32 one, and gives the
    CPU port's energies."""
    energies = {}
    for device in ("cpu", cuda):
        H = quimb_torch.MPO_ham_heis(16, dtype=torch.float64, device=device)
        p0 = quimb_torch.MPS_rand_state(16, 8, seed=2, dtype=torch.float64,
                                        device=device)
        dmrg = quimb_torch.DMRG2(H, bond_dims=16, cutoffs=0.0, p0=p0)
        energies[str(device)] = []
        for d in "RLRL":
            before = dict(ck.LAUNCHES)
            energies[str(device)].append(
                dmrg.sweep(d, max_bond=16, cutoff=0.0, canonize=d == "R"))
            if device == cuda:
                n = ck.LAUNCHES["sandwich_f64"] - before["sandwich_f64"]
                # ncv (8) matvecs at each of the 15 bonds
                assert n >= 8 * 15
                assert ck.LAUNCHES["sandwich_tf32"] == before["sandwich_tf32"]
    # float64 on both; the sums run in other orders
    np.testing.assert_allclose(energies["cuda"], energies["cpu"],
                               rtol=1e-10)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_1site_and_segment_sandwich_match_plain(cuda, dtype, tol):
    """The one-site operands (DMRG1) and the per-segment operand sets
    (ParallelDMRG), prepared and applied through the kernel, give the
    plain einsums of the effective Hamiltonians."""
    from quimb_torch.tensor.tn1d import dmrg as td
    from quimb_torch.tensor.tn1d import dmrg_jacobi as tj
    from quimb_torch.tensor.tn1d import dmrg_parallel as tp

    rng = np.random.default_rng(4)
    cl, cr, d, w, S = 24, 20, 2, 5, 3

    def on_card(*xs):
        return [torch.as_tensor(x, dtype=dtype, device=cuda) for x in xs]

    L, W, R, theta = on_card(rng.standard_normal((cl, w, cl)),
                             rng.standard_normal((w, w, d, d)),
                             rng.standard_normal((cr, w, cr)),
                             rng.standard_normal((cl, d, cr)))
    want = td._heff_matvec_1site(td._fuse_lw(L.double(), W.double()),
                                 R.double(), theta.double())
    A, B = td._sandwich_operands_1site(L, W, R)
    before = ck.LAUNCHES[_KERNEL[dtype]]
    got = ck.prepare_sandwich(A, B)(theta.reshape(cl * d, cr))
    assert ck.LAUNCHES[_KERNEL[dtype]] == before + 1
    rel = torch.linalg.norm(got.double().reshape(want.shape) - want) \
        / torch.linalg.norm(want)
    assert rel.item() <= tol

    LW1, W2R, th = on_card(rng.standard_normal((S, cl, w, d, d, cl)),
                           rng.standard_normal((S, w, d, d, cl, cl)),
                           rng.standard_normal((S, cl, d, d, cl)))
    want = tj._batched_matvec(LW1.double(), W2R.double(), th.double())
    A, B = tp._sandwich_stacks(LW1, W2R)
    heffs = [ck.prepare_sandwich(A[i], B[i]) for i in range(S)]
    before = ck.LAUNCHES[_KERNEL[dtype]]
    got = tp._matvec_via_sandwich(heffs, th.reshape(S, cl * d, d * cl))
    assert ck.LAUNCHES[_KERNEL[dtype]] == before + S
    rel = torch.linalg.norm(got.double().reshape(want.shape) - want) \
        / torch.linalg.norm(want)
    assert rel.item() <= tol


def test_dmrg1_float64_through_dmma_kernel(cuda):
    """A float64 DMRG1 run on the card launches the FP64 kernel at every
    one-site solve and gives the CPU port's energies."""
    energies = {}
    for device in ("cpu", cuda):
        H = quimb_torch.MPO_ham_heis(16, dtype=torch.float64, device=device)
        p0 = quimb_torch.MPS_rand_state(16, 8, seed=3, dtype=torch.float64,
                                        device=device)
        dmrg = quimb_torch.DMRG1(H, bond_dims=8, cutoffs=0.0, p0=p0)
        before = dict(ck.LAUNCHES)
        energies[str(device)] = [
            dmrg.sweep(d, max_bond=8, cutoff=0.0, canonize=d == "R")
            for d in "RLRL"
        ]
        if device == cuda:
            n = ck.LAUNCHES["sandwich_f64"] - before["sandwich_f64"]
            # 8 matvecs at the 14 inner sites, 4 at each end, per sweep
            assert n == 4 * (14 * 8 + 2 * 4)
            assert ck.LAUNCHES["sandwich_tf32"] == before["sandwich_tf32"]
    # float64 on both; the sums run in other orders
    np.testing.assert_allclose(energies["cuda"], energies["cpu"],
                               rtol=1e-10)


def test_parallel_dmrg_matches_cpu(cuda, monkeypatch):
    """ParallelDMRG at L=16, chi=24, S=2 on the card, from one float64
    DMRG2 state and one random start of the split, against its CPU run."""
    from quimb_torch.ops import decomp
    from quimb_torch.tensor.tn1d.dmrg_parallel import ParallelDMRG

    draw = decomp._random_start
    # the start drawn on the CPU, so that both devices iterate from it
    monkeypatch.setattr(
        decomp, "_random_start",
        lambda shape, dtype, device, seed: draw(shape, dtype, "cpu",
                                                seed).to(device))
    H = quimb_torch.MPO_ham_heis(16, dtype=torch.float64, device="cpu")
    dmrg = quimb_torch.DMRG2(H, bond_dims=8, cutoffs=1e-10,
                             p0=quimb_torch.MPS_rand_state(
                                 16, 8, seed=36, dtype=torch.float64,
                                 device="cpu"))
    dmrg.sweep("R", max_bond=8, cutoff=1e-10)
    energies = {}
    for device in ("cpu", cuda):
        pd = ParallelDMRG([A.to(device) for A in dmrg.state],
                          [W.to(device) for W in H], max_bond=24,
                          n_segments=2)
        before = dict(ck.LAUNCHES)
        energies[str(device)] = [pd.sweep() for _ in range(4)]
        if device == cuda:
            n = ck.LAUNCHES["sandwich_f64"] - before["sandwich_f64"]
            # 3 half-sweeps of 7 bonds, 8 matvecs a solve: 2 segments,
            # then 1 at the offset, twice
            assert n == 2 * 3 * 7 * 8 * (2 + 1)
            assert ck.LAUNCHES["sandwich_tf32"] == before["sandwich_tf32"]
    # float64 on both from one start; the bond bases' signs come from
    # cuSOLVER on the card and LAPACK on the CPU, and the subspace split
    # depends on them at about 1e-8 after a few sweeps (CPU parity tests)
    np.testing.assert_allclose(energies["cuda"], energies["cpu"], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-3)])
def test_tebd_quench_matches_cpu(cuda, dtype, tol):
    """The fused TEBD quench at L=12, max_bond 16, on the card (complex128
    through cuSOLVER's gesvdj, complex64 through its gesvd) against the
    port's CPU run (LAPACK): the half-chain entropy after each step."""
    entropies = {}
    for device in ("cpu", cuda):
        tebd = quimb_torch.TEBD(
            quimb_torch.MPS_neel_state(12, dtype=dtype, device=device),
            quimb_torch.ham_1d_heis(12),
            split_opts={"max_bond": 16, "cutoff": 1e-10})
        entropies[str(device)] = []
        for k in range(1, 13):
            tebd.update_to(k * 0.05, dt=0.05)
            entropies[str(device)].append(tebd.entropy())
        Bs, ls = tebd._vidal
        assert Bs.device.type == torch.device(device).type
        assert Bs.dtype == {torch.float64: torch.complex128,
                            torch.float32: torch.complex64}[dtype]
        assert ls.dtype == dtype
    # the same complex SVDs in another library. complex128: round-off over
    # 12 * 15 batched splits. complex64: each split drops the values whose
    # weight is below float32's resolution of the total, and which values
    # those are differs between the libraries (1.7e-4 apart on an H100)
    np.testing.assert_allclose(entropies["cuda"], entropies["cpu"], rtol=0,
                               atol=tol)


def test_entry_points_default_to_the_card(cuda):
    """With no device, every builder puts its tensors on the card."""
    for tensors in (quimb_torch.MPS_rand_state(8, 4),
                    quimb_torch.MPO_ham_heis(8),
                    quimb_torch.MPS_computational_state("01" * 4),
                    quimb_torch.MPS_neel_state(8)):
        assert all(t.is_cuda for t in tensors)
