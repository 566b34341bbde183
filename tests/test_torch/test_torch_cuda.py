"""quimb_torch on a CUDA GPU: the hand-written sandwich kernels (3xTF32
for float32, FP64 tensor cores for float64) against their plain version,
small DMRG2, DMRG1, ParallelDMRG and TEBD runs against the CPU port (real
and complex, chains and rings), the checked complex SVD, the exact layer's
matvecs and solvers, the object layer, a circuit's amplitudes and samples,
and the 2D layer's SimpleUpdate, energies and FullUpdate; the sharded
DMRG and the row-sharded exact core in a one-rank NCCL world.

Every test here needs a GPU and skips without one. The file imports no
JAX; on a GPU machine run it without the JAX setup of the test
configuration, from the root of the repository::

    python -m pytest tests/test_torch/test_torch_cuda.py -p no:cacheprovider --noconftest
"""

import numpy as np
import pytest
import torch

import quimb_torch
from quimb_torch import core
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


def _on(tn, device):
    """A copy of the network ``tn`` with its arrays on ``device``."""
    tn = tn.copy()
    tn.apply_to_arrays(lambda a: a.to(device))
    return tn


def _dmrg2(H, p0, bond_dims, split="svd"):
    """DMRG2 with one split on every device: the card's default is the
    subspace split, the CPU's the SVD."""
    dmrg = quimb_torch.DMRG2(H, bond_dims=bond_dims, cutoffs=0.0, p0=p0)
    dmrg.opts["bond_compress_method"] = split
    return dmrg


def test_dmrg_matches_cpu(cuda):
    """A float64 DMRG2 run through the kernel gives the CPU port's
    energies (the plain einsum there)."""
    energies = {}
    for device in ("cpu", cuda):
        H = quimb_torch.MPO_ham_heis(16, device=device)
        p0 = quimb_torch.MPS_rand_state(16, 8, seed=1, device=device)
        dmrg = _dmrg2(H, p0, 16)
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
        dmrg = _dmrg2(H, p0, 16)
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
        dmrg = _dmrg2(H, p0, 16)
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


def test_dmrg_default_split_on_the_card(cuda, monkeypatch):
    """On the card DMRG2 and DMRG1 split by quimb_tpu's accelerator
    default, "svd:sub" ("svd:sub0" at cutoff 0), and DMRG2's sweeps on it
    follow a CPU run of the same split from the same start draws."""
    from quimb_torch.ops import decomp

    draw = decomp._random_start
    # the start drawn on the CPU, so that both devices iterate from it
    monkeypatch.setattr(
        decomp, "_random_start",
        lambda shape, dtype, device, seed: draw(shape, dtype, "cpu",
                                                seed).to(device))
    H = quimb_torch.MPO_ham_heis(16, device=cuda)
    p0 = quimb_torch.MPS_rand_state(16, 8, seed=1, device=cuda)
    assert quimb_torch.DMRG2(H, p0=p0).opts["bond_compress_method"] == \
        "svd:sub"
    assert quimb_torch.DMRG1(H, p0=p0).opts["bond_compress_method"] == \
        "svd:sub"
    energies = {}
    for device in ("cpu", cuda):
        H = quimb_torch.MPO_ham_heis(16, device=device)
        p0 = quimb_torch.MPS_rand_state(16, 8, seed=1, device=device)
        dmrg = _dmrg2(H, p0, 16, split="svd:sub")
        energies[str(device)] = [
            dmrg.sweep(d, max_bond=16, cutoff=0.0, canonize=d == "R")
            for d in "RLRL"
        ]
    # float64 on both from one start; the bond bases' signs come from
    # cuSOLVER on the card and LAPACK on the CPU, and the chi=16 subspace
    # split depends on them: 1.6e-6 apart after four sweeps on an H100
    np.testing.assert_allclose(energies["cuda"], energies["cpu"], rtol=0,
                               atol=1e-5)


def test_complex_svd_redone_on_the_card(cuda, monkeypatch):
    """Where gesvdj fails to converge, the complex SVD redoes the batch
    with gesvd on the card, counts it, and returns its factors; a failure
    of gesvd too raises."""
    from quimb_torch.ops import decomp

    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 12, 10)) + 1j * rng.standard_normal(
        (3, 12, 10))
    call = decomp._svd_call
    drivers = []

    def failing_gesvdj(a, driver):
        drivers.append((a.dtype, a.device.type, driver))
        if driver == "gesvdj":
            raise torch.linalg.LinAlgError("gesvdj failed to converge")
        return call(a, driver)

    monkeypatch.setattr(decomp, "_svd_call", failing_gesvdj)
    for dtype, tol in ((torch.complex128, 1e-12), (torch.complex64, 1e-5)):
        t = torch.as_tensor(x, dtype=dtype, device=cuda)
        before = dict(decomp.SVD_REDOS)
        drivers.clear()
        U, s, VH = decomp.safe_svd(t)
        assert drivers == [(torch.complex128, "cuda", "gesvdj"),
                           (torch.complex128, "cuda", "gesvd")]
        assert decomp.SVD_REDOS == {**before, dtype: before[dtype] + 1}
        assert U.dtype == VH.dtype == dtype and U.is_cuda
        rec = (U * s.to(dtype)[..., None, :]) @ VH
        rel = torch.linalg.norm(rec - t) / torch.linalg.norm(t)
        assert rel.item() <= tol

    monkeypatch.setattr(decomp, "_svd_call", lambda a, driver: (
        _ for _ in ()).throw(torch.linalg.LinAlgError("no convergence")))
    with pytest.raises(torch.linalg.LinAlgError):
        decomp.safe_svd(torch.as_tensor(x, device=cuda))


def test_exact_matvecs_on_the_card(cuda):
    """The LocalTermsHam and ELL SparseHam matvecs of ham_heis(12) on the
    card against the dense H, real and complex vectors."""
    H = quimb_torch.ham_heis(12, sparse=True)
    Hd = H.toarray()
    rng = np.random.default_rng(6)
    x = rng.standard_normal(2**12)
    ops = (quimb_torch.device_operator(H), core.SparseHam(H, device=cuda))
    for v in (x, x + 1j * rng.standard_normal(2**12)):
        want = Hd @ v
        for op in ops:
            got = op.matvec(torch.as_tensor(v, device=cuda))
            assert got.is_cuda
            # float64 sums of at most 12 products per entry
            np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0,
                                       atol=1e-12 * np.abs(want).max())


def test_exact_core_on_the_card(cuda):
    """groundenergy and Evolution at N=12 through entry points called with
    no device: everything on the card, and the CPU port's numbers."""
    H = quimb_torch.ham_heis(12, sparse=True)
    e = quimb_torch.groundenergy(H)
    assert e.is_cuda and e.dtype == torch.float64
    # float64 Lanczos from one start vector on both
    assert float(e) == pytest.approx(
        float(quimb_torch.groundenergy(H, device="cpu")), rel=1e-12)
    states = {}
    for device in (None, "cpu"):
        p0 = quimb_torch.computational_state("01" * 6, device=device)
        evo = quimb_torch.Evolution(p0, H, method="expm")
        evo.update_to(0.5)
        states[device] = evo.pt
    assert states[None].is_cuda and states[None].dtype == torch.complex128
    np.testing.assert_allclose(states[None].cpu().numpy(),
                               states["cpu"].numpy(), rtol=0, atol=1e-12)


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
        pd = ParallelDMRG(_on(dmrg.state, device), _on(H, device),
                          max_bond=24, n_segments=2)
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
    """The fused TEBD quench at L=12, max_bond 16, on the card (through
    cuSOLVER's checked gesvdj in complex128, for complex64 too) against
    the port's CPU run (LAPACK): the half-chain entropy after each
    step."""
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
    # 12 * 15 batched splits. complex64: the card's SVD runs in complex128,
    # the CPU's in complex64 (1.7e-4 apart on an H100 when both ran in
    # complex64 and the mask dropped the weight below float32's
    # resolution of the total)
    np.testing.assert_allclose(entropies["cuda"], entropies["cpu"], rtol=0,
                               atol=tol)


def test_entry_points_default_to_the_card(cuda):
    """With no device, every builder puts its tensors on the card."""
    for tn in (quimb_torch.MPS_rand_state(8, 4),
               quimb_torch.MPO_ham_heis(8),
               quimb_torch.MPS_computational_state("01" * 4),
               quimb_torch.MPS_neel_state(8)):
        assert all(t.data.is_cuda for t in tn)


# -- the tensor-network object layer on the card --------------------------------


def _random_network(n_tensors, seed, dtype):
    """A random connected network of ``n_tensors`` tensors: a chain plus
    random extra bonds of sizes 2-3, a few open indices."""
    from quimb_torch.tensor import Tensor, TensorNetwork

    rng = np.random.default_rng(seed)
    inds = [[] for _ in range(n_tensors)]
    edges = [(i, i + 1) for i in range(n_tensors - 1)]
    edges += [tuple(int(x) for x in rng.choice(n_tensors, 2, replace=False))
              for _ in range(n_tensors // 2)]
    sizes = {}
    for k, (a, b) in enumerate(edges):
        inds[a].append(f"e{k}")
        inds[b].append(f"e{k}")
        sizes[f"e{k}"] = int(rng.integers(2, 4))
    for k in range(4):
        t = int(rng.integers(0, n_tensors))
        inds[t].append(f"o{k}")
        sizes[f"o{k}"] = 2
    arrays = []
    for term in inds:
        shape = [sizes[ix] for ix in term]
        x = rng.standard_normal(shape)
        if dtype.is_complex:
            x = x + 1j * rng.standard_normal(shape)
        arrays.append(x)

    def build(device):
        return TensorNetwork([
            Tensor(torch.as_tensor(x, dtype=dtype, device=device),
                   inds=term, tags={f"T{i}"})
            for i, (x, term) in enumerate(zip(arrays, inds))])

    return build


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("optimize", ["greedy", "auto"])
def test_tn_contraction_on_card_matches_cpu(cuda, dtype, optimize):
    """A 40-tensor network contracted on the card and on the CPU: the same
    path (the expression cache holds it), float64 round-off, 1e-12
    relative."""
    build = _random_network(40, seed=3, dtype=dtype)
    tn_gpu, tn_cpu = build(cuda), build("cpu")
    assert all(t.data.is_cuda for t in tn_gpu)
    out = tuple(sorted(tn_cpu.outer_inds()))
    got = tn_gpu.contract(..., output_inds=out, optimize=optimize)
    ref = tn_cpu.contract(..., output_inds=out, optimize=optimize)
    assert got.data.is_cuda and got.dtype == dtype
    rel = torch.linalg.norm(got.data.cpu() - ref.data) / torch.linalg.norm(
        ref.data)
    assert rel.item() <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("method", ["svd", "svd:eig", "qr", "lq",
                                    "qr:cholesky", "polar_right",
                                    "polar_left", "lu", "eigh", "cholesky"])
def test_tensor_split_on_card_matches_cpu(cuda, dtype, method):
    """``tensor_split`` of one tensor on the card and on the CPU, each
    driver: the product of the factors (gauge-free), 1e-10 relative, and
    every factor on the card."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 6, 4, 6))
    if dtype.is_complex:
        x = x + 1j * rng.standard_normal(x.shape)
    if method in ("eigh", "cholesky"):
        m = x.reshape(24, 24)
        x = (m @ m.conj().T + 24 * np.eye(24)).reshape(4, 6, 4, 6)
    cpu, card = (_split_product(x, dtype, method, device)
                 for device in ("cpu", cuda))
    rel = torch.linalg.norm(card - cpu) / torch.linalg.norm(cpu)
    assert rel.item() <= 1e-10


def _split_product(x, dtype, method, device):
    """The product of ``tensor_split``'s factors of ``x`` on ``device``,
    read back to the CPU; every factor must lie on ``device``."""
    from quimb_torch.tensor import Tensor, tensor_contract

    t = Tensor(torch.as_tensor(x, dtype=dtype, device=device),
               inds=("a", "b", "c", "d"))
    parts = t.split(("a", "b"), method=method, cutoff=0.0, get="tensors")
    assert all(p.data.device.type == torch.device(device).type
               for p in parts)
    return tensor_contract(*parts).transpose("a", "b", "c", "d").data.cpu()


def test_tensor_of_numpy_lands_on_card(cuda):
    from quimb_torch.tensor import COPY_tensor, Tensor

    t = Tensor(np.ones((2, 3)), inds=("a", "b"))
    assert t.data.is_cuda and t.dtype == torch.float64
    assert COPY_tensor(2, ("a", "b")).data.is_cuda
    assert Tensor(torch.ones(2), inds=("a",)).data.device.type == "cpu"


def _brickwork_qasm(n, depth):
    """benchref/circuit53.py's seeded brickwork as OpenQASM 2 (numpy only,
    loaded by its path)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "benchref", "circuit53.py")
    spec = importlib.util.spec_from_file_location("circuit53", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.qasm_circuit(n, depth)


@pytest.mark.parametrize("route", ["batched", "per_sample"])
def test_circuit_on_card_matches_cpu(cuda, route, monkeypatch):
    """A 16-qubit depth-8 circuit built with no device (so on the card)
    against the same circuit on the CPU: amplitudes and a reduced density
    matrix to 1e-12 relative in complex128, and 8 samples of one seed
    identical on both routes of the breadth-first sampler."""
    from quimb_torch.tensor import Circuit
    from quimb_torch.tensor.circuit import core as circuit_core

    if route == "per_sample":
        monkeypatch.setattr(circuit_core, "_EXPR_FLOPS_LIMIT", 0)
    q = _brickwork_qasm(16, 8)
    card = Circuit.from_openqasm2_str(q)
    cpu = Circuit.from_openqasm2_str(q, device="cpu")
    assert card.device.type == "cuda"
    rng = np.random.default_rng(0)
    for b in ["0" * 16, *("".join(rng.choice(["0", "1"], size=16))
                          for _ in range(3))]:
        a, c = card.amplitude(b), cpu.amplitude(b)
        assert abs(a - c) <= 1e-12 * abs(c)
    rho = card.partial_trace((3, 4))
    assert rho.is_cuda
    rel = torch.linalg.norm(rho.cpu() - cpu.partial_trace((3, 4)))
    assert rel.item() <= 1e-12 * torch.linalg.norm(rho).item()
    assert list(card.sample(8, seed=42, group_size=5)) == \
        list(cpu.sample(8, seed=42, group_size=5))


# -- the MPS / MPO object layer on the card -----------------------------------


def test_mps_stays_on_the_card(cuda):
    """An MPS built on the card stays there through canonize, compress,
    an MPO's apply and sampling, and gives the CPU copy's values."""
    from quimb_torch.tensor.tn1d.core import expec_TN_1D

    psi = quimb_torch.MPS_rand_state(12, 8, seed=5, device=cuda)
    H = quimb_torch.MPO_ham_heis(12, device=cuda)
    cpu = _on(psi, "cpu")
    psi.canonize(6)
    assert all(t.data.is_cuda for t in psi)
    Hpsi = H.apply(psi)
    assert all(t.data.is_cuda for t in Hpsi)
    assert max(Hpsi.bond_sizes()) == 40
    Hpsi.compress(max_bond=8, cutoff=0.0)
    assert all(t.data.is_cuda for t in Hpsi)
    assert max(Hpsi.bond_sizes()) == 8
    samples = list(psi.sample(3, seed=1))
    want = list(cpu.sample(3, seed=1))
    assert [c for c, _ in samples] == [c for c, _ in want]
    # float64 probabilities summed in other orders
    np.testing.assert_allclose([w for _, w in samples],
                               [w for _, w in want], rtol=1e-12)
    # float64 sums in other orders
    e = expec_TN_1D(psi.H, Hpsi)
    assert e.is_cuda
    e_cpu = expec_TN_1D(cpu.H, _on(H, "cpu").apply(cpu).compress(
        max_bond=8, cutoff=0.0))
    assert abs(e.item() - e_cpu.item()) < 1e-10 * abs(e_cpu.item())


def test_circuit_mps_defaults_to_the_card(cuda):
    """``CircuitMPS`` with no device puts its state on the card, and its
    amplitudes are the CPU circuit's."""
    from quimb_torch.tensor import CircuitMPS

    circ = CircuitMPS(4)
    cpu = CircuitMPS(4, device="cpu")
    for c in (circ, cpu):
        c.apply_gate("H", 0)
        c.apply_gate("CNOT", 0, 1)
        c.apply_gate("CNOT", 1, 3)
    assert circ.device.type == "cuda"
    assert all(t.data.is_cuda for t in circ.psi)
    for b in ("0000", "1101"):
        assert abs(circ.amplitude(b) - cpu.amplitude(b)) < 1e-14


def test_dmrg2_from_objects_launches_the_kernel(cuda):
    """DMRG2 built from an MPO and an MPS object on the card launches the
    float64 sandwich kernel, and its ``.state`` is an MPS on the card."""
    H = quimb_torch.MPO_ham_heis(10, device=cuda)
    p0 = quimb_torch.MPS_rand_state(10, 8, seed=4, device=cuda)
    dmrg = quimb_torch.DMRG2(H, bond_dims=8, cutoffs=0.0, p0=p0)
    before = ck.LAUNCHES["sandwich_f64"]
    dmrg.sweep("R", max_bond=8, cutoff=0.0)
    assert ck.LAUNCHES["sandwich_f64"] - before >= 8 * 9
    state = dmrg.state
    assert isinstance(state, quimb_torch.MatrixProductState)
    assert all(t.data.is_cuda for t in state)


def _peps_arrays(L, D, seed):
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal(
        [D] * sum((i < L - 1, j < L - 1, i > 0, j > 0)) + [2])
        for j in range(L)] for i in range(L)]


def test_simple_update_step_on_card_matches_cpu(cuda):
    """One fused SimpleUpdate step of a 4 x 4, D=3 PEPS on the card keeps
    its stacks there and gives the CPU's gauges and simple energy
    (float64, 1e-10); the PEPS built with no device lands on the card."""
    arrays = _peps_arrays(4, 3, seed=2)
    out = {}
    for dev in (None, "cpu"):
        psi = quimb_torch.PEPS([[torch.as_tensor(a, device=dev or cuda)
                                 for a in row] for row in arrays])
        su = quimb_torch.SimpleUpdate(psi, quimb_torch.ham_2d_heis(4, 4),
                                      D=3, compute_energy_every=None,
                                      compute_energy_final=False)
        su.evolve(1, tau=0.3)
        assert su._fstacks[0].device.type == ("cpu" if dev else "cuda")
        out[dev] = ({k: v.cpu() for k, v in su.gauges.items()},
                    su.compute_energy_simple())
    (g_card, e_card), (g_cpu, e_cpu) = out[None], out["cpu"]
    for k, v in g_cpu.items():
        assert torch.allclose(g_card[k], v, atol=1e-10)
    assert abs(e_card - e_cpu) <= 1e-10 * abs(e_cpu)
    assert quimb_torch.PEPS_rand(2, 2, 2, seed=1)[
        "I0,0"].data.device.type == "cuda"


def test_peps_energy_on_card_matches_cpu(cuda):
    """``compute_local_expectation`` of a 3 x 3 PEPS runs on the card and
    gives the CPU's energy (float64, 1e-10)."""
    arrays = _peps_arrays(3, 2, seed=3)
    ham = quimb_torch.ham_2d_heis(3, 3)
    es = [quimb_torch.PEPS([[torch.as_tensor(a, device=dev) for a in row]
                            for row in arrays]).compute_local_expectation(
        ham.terms, max_bond=8) for dev in (cuda, "cpu")]
    assert abs(es[0] - es[1]) <= 1e-10 * abs(es[1])


def test_complex_dmrg_on_card_matches_cpu(cuda, monkeypatch):
    """complex128 DMRG2, DMRG1 and ParallelDMRG run on the card through
    the plain product (the dtype rule of ``resolve_sandwich``: no sandwich
    launch) and give the CPU port's energies. The splits are SVDs on both
    devices ("svd"); ParallelDMRG's batched split starts from one draw
    taken on the CPU."""
    from quimb_torch.ops import decomp
    from quimb_torch.tensor.tn1d.dmrg_parallel import ParallelDMRG

    H = quimb_torch.MPO_ham_heis(12, dtype=torch.complex128, device="cpu")
    p0 = quimb_torch.MPS_rand_state(12, 8, seed=3, dtype=torch.complex128,
                                    device="cpu")
    energies = {}
    before = dict(ck.LAUNCHES)
    draw = decomp._random_start
    monkeypatch.setattr(
        decomp, "_random_start",
        lambda shape, dtype, device, seed: draw(shape, dtype, "cpu",
                                                seed).to(device))
    for device in ("cpu", cuda):
        out = energies[str(device)] = []
        for cls in (quimb_torch.DMRG2, quimb_torch.DMRG1):
            dmrg = cls(_on(H, device), bond_dims=8, cutoffs=1e-10,
                       p0=_on(p0, device))
            assert dmrg._sandwich is ck.prepare_sandwich_reference
            dmrg.opts["bond_compress_method"] = "svd"
            out += [dmrg.sweep(d, max_bond=8, cutoff=1e-10,
                               canonize=d == "R") for d in "RLR"]
        pd = ParallelDMRG(_on(dmrg.state, device), _on(H, device),
                          max_bond=8, n_segments=2)
        out += [pd.sweep() for _ in range(2)]
    assert ck.LAUNCHES == before
    # complex128 on both; cuSOLVER's and LAPACK's SVD, eigh and QR, and
    # the batched subspace split's phases (CPU parity tests: 1e-6)
    np.testing.assert_allclose(energies["cuda"][:6], energies["cpu"][:6],
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(energies["cuda"], energies["cpu"], rtol=0,
                               atol=1e-6)


def test_ring_sweep_on_card_matches_cpu(cuda):
    """One segmented sweep of a 12-site ring (bond 4 grown to 6) on the
    card against the CPU, both drawing the CPU generator's numbers: the
    energy agrees to 1e-4 (each closure truncates at 1e-6 of its largest
    value, and where the cut splits a degenerate pair cuSOLVER and LAPACK
    keep different vectors of it: 4.9e-5 apart on an H100) and the state
    stays cyclic on the card."""
    from quimb_torch.tensor.tn1d import dmrg_cyclic as tc

    energies = {}
    for device in ("cpu", cuda):
        dmrg = quimb_torch.DMRG2(
            quimb_torch.MPO_ham_heis(12, cyclic=True, device=device),
            bond_dims=4, cyclic_mode="segmented",
            p0=quimb_torch.MPS_rand_state(12, 4, cyclic=True, seed=2,
                                          dtype=torch.float64,
                                          device=device))
        eng = dmrg._cyc
        gen = torch.Generator().manual_seed(0)
        eng._normal = lambda shape, gen=gen, dev=device: torch.randn(
            shape, generator=gen, dtype=torch.float32).to(dev)
        dmrg.opts["bond_compress_method"] = "svd"
        dmrg.opts["periodic_segment_size"] = 1 / 3
        energies[str(device)] = dmrg.sweep("R", max_bond=6, cutoff=1e-10)
        psi = dmrg.state
        assert psi.cyclic and eng.chi == 6
        assert all(t.data.device.type == torch.device(device).type
                   for t in psi)
        assert isinstance(eng, tc.CyclicSweeper)
    assert abs(energies["cuda"] - energies["cpu"]) < 1e-4


def test_ring_tebd_on_card_matches_cpu(cuda):
    """TEBD of a 6-site ring (complex128, bond by bond, the wrap bond
    included) on the card gives the CPU's entropies and ``err``."""
    out = {}
    for device in ("cpu", cuda):
        tebd = quimb_torch.TEBD(
            quimb_torch.MPS_neel_state(6, cyclic=True, device=device),
            quimb_torch.ham_1d_heis(6, cyclic=True),
            split_opts={"max_bond": 8, "cutoff": 1e-10})
        tebd.update_to(0.1, dt=0.05)
        assert next(iter(tebd.pt)).data.device.type == \
            torch.device(device).type
        out[str(device)] = ([tebd.entropy(i) for i in range(1, 6)],
                            tebd.err)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=1e-10)
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-10


def test_full_update_gate_on_card_matches_cpu(cuda):
    """One FullUpdate step (4 ALS gates) of a 2 x 2, D=2 PEPS on the card
    gives the CPU's energy (float64, 1e-10); an autodiff step too, to the
    fits' own agreement (1e-6)."""
    arrays = _peps_arrays(2, 2, seed=4)
    for strategy, tol in (("als", 1e-10), ("autodiff", 1e-6)):
        es = []
        for dev in (cuda, "cpu"):
            psi = quimb_torch.PEPS([[torch.as_tensor(a, device=dev)
                                     for a in row] for row in arrays])
            fu = quimb_torch.FullUpdate(psi, quimb_torch.ham_2d_heis(2, 2),
                                        D=2, chi=16, fit_strategy=strategy,
                                        compute_energy_final=False)
            fu.evolve(1, tau=0.3)
            assert fu.state["I0,0"].data.device.type == \
                torch.device(dev).type
            es.append(fu.compute_energy())
        assert abs(es[0] - es[1]) <= tol * abs(es[1])


def test_jacobi_halfsweep_on_card_matches_cpu(cuda):
    """One Jacobi half-sweep per parity (L=12, chi=16, float64, one start
    matrix) on the card gives the CPU's Ritz energies (1e-10) and
    site-pair products (1e-9: the whitening by Cholesky factors of the norm
    environments amplifies the two libraries' rounding, 1.5e-10 on an H100;
    a product carries its Ritz vector's sign, which cuSOLVER and LAPACK
    choose apart), and launches no sandwich kernel."""
    from quimb_torch.tensor.tn1d import dmrg_jacobi as tj

    H = quimb_torch.MPO_ham_heis(12, device="cpu")
    d = quimb_torch.DMRG2(H, bond_dims=[8, 16], cutoffs=1e-10)
    d.solve(tol=1e-9, verbosity=0)
    Ms = tj.mps_to_stack(d.state, 16)
    Ws = tj.mpo_to_padded_stack(H)
    omega = np.random.default_rng(2).standard_normal((32, 32))
    before = dict(ck.LAUNCHES)
    for parity in (0, 1):
        out = {}
        for dev in ("cpu", cuda):
            M, e = tj._jacobi_halfsweep(Ms.to(dev), Ws.to(dev), parity, 8,
                                        16, omega=omega)
            assert M.device.type == torch.device(dev).type
            out[str(dev)] = (M.cpu().numpy(), e.cpu().numpy())
        np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=0,
                                   atol=1e-10)
        for i in range(parity, 11, 2):
            pair = {k: np.einsum("kpc,cqr->kpqr", v[0][i], v[0][i + 1])
                    for k, v in out.items()}
            sign = np.sign(np.vdot(pair["cuda"], pair["cpu"]))
            np.testing.assert_allclose(sign * pair["cuda"], pair["cpu"],
                                       rtol=0, atol=1e-9)
    assert dict(ck.LAUNCHES) == before


def test_simple_update_gen_step_on_card_matches_cpu(cuda):
    """Two SimpleUpdateGen steps of the Heisenberg model on a 2 x 2-cell
    kagome lattice (D=2, float64, the same start arrays) on the card give
    the CPU's gauges and cluster energy (1e-10)."""
    edges = quimb_torch.edges_2d_kagome(2, 2)
    rng = np.random.default_rng(3)
    psi0 = quimb_torch.TN_from_edges_and_fill_fn(
        lambda s: rng.standard_normal(s), edges, 2, phys_dim=2, device="cpu")
    out = {}
    for dev in ("cpu", cuda):
        psi = psi0.copy()
        psi.apply_to_arrays(lambda a: a.to(dev))
        su = quimb_torch.SimpleUpdateGen(psi, quimb_torch.ham_gen_heis(edges),
                                         D=2, compute_energy_final=False)
        su.evolve(2, tau=0.2)
        assert all(t.data.device.type == torch.device(dev).type
                   for t in su.state)
        out[str(dev)] = (su.gauges, su.compute_energy())
    assert set(out["cuda"][0]) == set(out["cpu"][0])
    for ix, g in out["cpu"][0].items():
        np.testing.assert_allclose(out["cuda"][0][ix].cpu().numpy(),
                                   g.numpy(), rtol=0, atol=1e-10)
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-10


def test_simple_update_3d_step_on_card_matches_cpu(cuda):
    """One SimpleUpdate3D step of the 3D Heisenberg model on a 2 x 2 x 2
    PEPS3D (D=2, float64, the same start arrays) on the card gives the
    CPU's gauges (1e-10) and launches no sandwich kernel."""
    rng = np.random.default_rng(5)
    psi0 = quimb_torch.PEPS3D.from_fill_fn(
        lambda s: rng.standard_normal(s), 2, 2, 2, 2, device="cpu")
    before = dict(ck.LAUNCHES)
    out = {}
    for dev in ("cpu", cuda):
        psi = psi0.copy()
        psi.apply_to_arrays(lambda a: a.to(dev))
        su = quimb_torch.SimpleUpdate3D(psi, quimb_torch.ham_3d_heis(2, 2, 2),
                                        D=2)
        su.evolve(1, tau=0.2)
        assert all(t.data.device.type == torch.device(dev).type
                   for t in su.state)
        out[str(dev)] = su.gauges
    assert set(out["cuda"]) == set(out["cpu"])
    for ix, g in out["cpu"].items():
        np.testing.assert_allclose(out["cuda"][ix].cpu().numpy(), g.numpy(),
                                   rtol=0, atol=1e-10)
    assert dict(ck.LAUNCHES) == before


def test_hv1bp_iteration_on_card_matches_cpu(cuda):
    """One HV1BP iteration, then the converged estimate, of the 3D Ising
    model in a field (hyper form, 3 x 3 x 3) on the card give the CPU's
    messages (1e-14) and log Z (1e-12 relative)."""
    from quimb_torch.tensor import belief_propagation as bp

    out = {}
    for dev in ("cpu", cuda):
        tn = quimb_torch.HTN3D_classical_ising_partition_function(
            3, 3, 3, beta=0.2216544, h=0.1, device=dev)
        hv = bp.HV1BP(tn)
        dm = hv.iterate()
        assert hv.M.device.type == torch.device(dev).type
        mant, expo = bp.contract_hv1bp(tn, strip_exponent=True)
        out[str(dev)] = (hv.M.cpu().numpy(), dm,
                         expo + np.log10(abs(complex(mant))))
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0,
                               atol=1e-14)
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-14
    assert out["cuda"][2] == pytest.approx(out["cpu"][2], rel=1e-12)


def _rq_loss(H):
    def loss(psi):
        bra = psi.H.reindex({psi.site_ind(i): H.lower_ind(i)
                             for i in range(psi.L)})
        num = (bra & H & psi).contract(..., optimize="auto")
        return (num / (psi.H @ psi)).real
    return loss


@pytest.mark.parametrize("optimizer", ["L-BFGS-B", "adam"])
def test_tnoptimizer_on_card_matches_cpu(cuda, optimizer):
    """TNOptimizer with complex parameters on the card: the gradients stay
    there (only scipy's vector crosses to the host), and the losses follow
    the CPU run's (1e-10 relative)."""
    out = {}
    for dev in ("cpu", cuda):
        psi = quimb_torch.MPS_rand_state(8, 4, seed=3, dtype="complex128",
                                         device="cpu")
        psi.apply_to_arrays(lambda x: x.to(dev))
        H = quimb_torch.MPO_ham_heis(8, device=dev)
        opt = quimb_torch.TNOptimizer(psi, _rq_loss(H), optimizer=optimizer,
                                      progbar=False)
        val, grads = opt._value_and_grad(opt.params)
        assert val.device.type == torch.device(dev).type
        assert all(g.device.type == torch.device(dev).type
                   for g in grads.values())
        tn = opt.optimize(4)
        assert all(p.device.type == torch.device(dev).type
                   for p in opt.params.values())
        assert all(t.data.device.type == torch.device(dev).type for t in tn)
        out[str(dev)] = np.array(opt.losses)
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-10)


def test_linear_operator_and_slq_on_card_match_cpu(cuda):
    """A CUDA TNLinearOperator's products and dense form give the CPU's
    (1e-10); the SLQ estimate with the same probes within 1e-5 (its 16 x 16
    operator fills its Krylov space at K = n = 16, where the recurrence
    without reorthogonalization amplifies round-off: the card read 2.1e-7
    from the CPU, where complex128 CPU runs of two packages read 1.5e-8);
    the ALS fit's distance to its target within 1e-10, as the CPU tests
    hold it to quimb_tpu's (its solves are conditioned by the normal
    matrices)."""
    out = {}
    for dev in ("cpu", cuda):
        psi = quimb_torch.MPS_rand_state(8, 4, seed=5, device="cpu")
        target = quimb_torch.MPS_rand_state(8, 6, seed=6, device="cpu")
        for tn in (psi, target):
            tn.apply_to_arrays(lambda x: x.to(dev))
        A = psi.partial_trace_linop((2, 3, 4, 5))
        X = torch.ones(16, 3, dtype=torch.float64, device=dev)
        mm = A.matmat(X)
        assert mm.device.type == torch.device(dev).type
        est = quimb_torch.tensor_network_approx_spectral_function(
            A, quimb_torch.linalg.approx_spectral._np_xlogx, pos=True,
            seed=3, R=16)
        fit = psi.fit(target, steps=2)
        out[str(dev)] = (mm.cpu().numpy(), A.to_dense().cpu().numpy(), est,
                         fit.distance(target))
    for a, b in zip(out["cuda"][:2], out["cpu"][:2]):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)
    assert out["cuda"][2] == pytest.approx(out["cpu"][2], rel=1e-5)
    assert abs(out["cuda"][3] - out["cpu"][3]) <= 1e-10


@pytest.mark.parametrize("symmetry,sector,n", [
    ("U1", 6, 12), ("U1U1", (3, 2), 12), ("Z2", 1, 10), (None, None, 9)])
def test_coupled_ham_on_card_matches_cpu(cuda, symmetry, sector, n):
    """The matrix-free sector operator: a matvec, a block of columns and
    the ground energy on the card give the CPU's (1e-12, 1e-10)."""
    from quimb_torch.operator import HilbertSpace, heisenberg_from_edges

    edges = [(i, (i + 1) % n) for i in range(n)] + [(0, n // 2)]
    out = {}
    for dev in ("cpu", cuda):
        hs = HilbertSpace(n, symmetry=symmetry, sector=sector)
        b = heisenberg_from_edges(edges, j=(1.0, 1.0, 0.7), b=0.1,
                                  hilbert_space=hs)
        op = b.build_coupled_ham(dtype="float64", device=dev)
        assert op.configs.device.type == torch.device(dev).type
        X = torch.as_tensor(np.random.default_rng(1).standard_normal(
            (op.shape[0], 3)), device=dev)
        out[str(dev)] = ((op @ X[:, 0]).cpu().numpy(),
                         (op @ X).cpu().numpy(),
                         float(quimb_torch.groundenergy(op)))
    for a, b in zip(out["cuda"][:2], out["cpu"][:2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert out["cuda"][2] == pytest.approx(out["cpu"][2], abs=1e-10)


def test_circuit_dense_on_card_matches_cpu(cuda):
    """A 14-qubit brickwork with gates on distant, reversed and three
    qubits: the card's dense state, samples and local expectation give
    the CPU's."""
    out = {}
    for dev in ("cpu", cuda):
        lazy = quimb_torch.circ_ansatz_1D_brickwork(14, 4, seed=2,
                                                    device="cpu")
        c = quimb_torch.CircuitDense(14, device=dev)
        c.apply_gates(lazy.gates)
        for g in (("CNOT", 9, 2), ("CCNOT", 6, 1, 13), ("SWAP", 13, 0)):
            c.apply_gate(*g)
        zz = np.kron(np.diag([1.0, -1.0]), np.diag([1.0, -1.0]))
        out[str(dev)] = (c.psi.cpu().numpy(), list(c.sample(5, seed=4)),
                         complex(c.local_expectation(zz, (6, 7))))
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0,
                               atol=1e-12)
    assert out["cuda"][1] == out["cpu"][1]
    assert out["cuda"][2] == pytest.approx(out["cpu"][2], abs=1e-12)


def test_matrix_half_on_card_matches_cpu(cuda):
    """calc's entropies, negativity and concurrence of a 10-qubit ground
    state, and Evolution by RK45 (a ket, a Lindblad density operator) and
    by solve on the card give the CPU's: the same host step control takes
    the same steps."""
    from quimb_torch import calc
    from quimb_torch.core import dop, ikron, ptr
    from quimb_torch.gen.operators import pauli

    n, dims = 10, (2,) * 10
    out = {}
    for dev in ("cpu", cuda):
        H = quimb_torch.ham_heis(n, sparse=True)
        psi = quimb_torch.groundstate(H, tol=0.0, restarts=15, device=dev)
        vals = [calc.entropy_subsys(psi, dims, range(5)),
                calc.mutinf_subsys(psi, dims, (0, 1), (5, 6)),
                calc.logneg_subsys(psi, dims, (2, 3), (4, 5, 6)),
                calc.concurrence(ptr(psi, dims, (4, 5)))]
        p0 = quimb_torch.computational_state("01" * 5, device=dev)
        evo = quimb_torch.Evolution(p0, H, method="integrate")
        evo.update_to(0.5)
        Hd = quimb_torch.ham_heis(6, device=dev)
        ls = [ikron(pauli("Z", device=dev), (2,) * 6, i) for i in range(6)]
        r0 = dop(quimb_torch.computational_state("010101", device=dev))
        lind = quimb_torch.Evolution(r0, (Hd, ls, 0.1), method="integrate")
        lind.update_to(0.5)
        solve = quimb_torch.Evolution(r0, Hd, method="solve")
        solve.update_to(0.5)
        out[str(dev)] = (vals, evo.pt.cpu().numpy(), evo.steps,
                         lind.pt.cpu().numpy(), solve.pt.cpu().numpy())
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0,
                               atol=1e-10)
    assert out["cuda"][2] == out["cpu"][2]
    for k in (1, 3, 4):
        np.testing.assert_allclose(out["cuda"][k], out["cpu"][k], rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("cplx", [False, True])
def test_tnvmc_step_on_card_matches_cpu(cuda, cplx):
    """TNVMC's amplitudes, local energies, log-derivatives and one SR
    update from injected configurations on a 3 x 2 PEPS: the card against
    the CPU; and the exchange chains stay on the card."""
    from quimb_torch.experimental import ExchangeSampler, TNVMC
    from quimb_torch.operator import heisenberg_from_edges

    rng = np.random.default_rng(3)
    arrays = []
    for i in range(3):
        row = []
        for j in range(2):
            sh = [2] * sum((i < 2, j < 1, i > 0, j > 0)) + [2]
            a = rng.standard_normal(sh)
            row.append(a + 1j * rng.standard_normal(sh) if cplx else a)
        arrays.append(row)
    edges = [(0, 1), (2, 3), (4, 5), (0, 2), (2, 4), (1, 3), (3, 5)]
    configs = rng.integers(0, 2, (16, 6))
    out = {}
    for dev in ("cpu", cuda):
        psi = quimb_torch.PEPS([[torch.tensor(a, device=dev) for a in row]
                                for row in arrays], shape="urdlp")
        vmc = TNVMC(psi, heisenberg_from_edges(edges), nchains=16,
                    sampler=ExchangeSampler(6, nchains=16, seed=1))
        c = torch.as_tensor(configs, device=dev)
        w = torch.ones(16, dtype=torch.float64, device=dev)
        new, e, _ = vmc._update(vmc.params, c, w)
        O = vmc._grad_logs(vmc.params, c)
        out[str(dev)] = [x.cpu().numpy() for x in (
            vmc._log_amp_batch(vmc.params, c),
            vmc._local_energies(vmc.params, c), O, torch.cat(
                [(p - q).reshape(-1) for p, q in zip(vmc.params, new)]))]
        if dev != "cpu":
            chains = vmc._sample_batch(vmc.params, 12)
            assert chains.is_cuda and (chains.sum(dim=1) == 3).all()
        else:
            # the SR matrix's condition number bounds how far two float64
            # solves of it may drift apart
            Om = (O - O.mean(dim=0)).numpy()
            ev = np.linalg.eigvalsh(Om.conj().T @ Om / 16 + 1e-3 * np.eye(
                Om.shape[1]))
            cond = ev[-1] / ev[0]
    for got, want in zip(out["cuda"][:3], out["cpu"][:3]):
        np.testing.assert_allclose(got, want, rtol=1e-10,
                                   atol=1e-12 * np.abs(want).max())
    step_t, step_c = out["cuda"][3], out["cpu"][3]
    assert np.linalg.norm(step_t - step_c) <= \
        10 * cond * 2.0 ** -52 * np.linalg.norm(step_c)


@pytest.mark.parametrize("kind", ["exchange", "metropolis", "hamiltonian"])
def test_tnvmc_graph_replays_match_eager_steps(cuda, kind):
    """The proposal steps replayed as one CUDA graph move the chains as
    the same steps launched one by one (``_mh_step`` in a loop), from the
    same generator seed; a second call replays the captured graph with new
    parameters, and a new sampler gets a graph of its own."""
    from quimb_torch.experimental import (
        ExchangeSampler,
        HamiltonianSampler,
        MetropolisHastingsSampler,
        TNVMC,
    )
    from quimb_torch.operator import heisenberg_from_edges

    psi = quimb_torch.PEPS_rand(3, 3, 2, seed=4, dtype="float64")
    edges = [(i * 3 + j, i * 3 + j + 1) for i in range(3) for j in range(2)]
    edges += [(i * 3 + j, i * 3 + j + 3) for i in range(2) for j in range(3)]
    H = heisenberg_from_edges(edges)
    make = {
        "exchange": lambda: ExchangeSampler(9, nchains=32, seed=2),
        "metropolis": lambda: MetropolisHastingsSampler(9, nchains=32,
                                                        seed=2),
        "hamiltonian": lambda: HamiltonianSampler.from_ham(H, 9, nchains=32,
                                                           seed=2),
    }[kind]
    def eager(vmc, params, n):
        configs = vmc._configs(vmc.sampler.configs)
        gen = vmc.sampler._generator(configs.device)
        p = torch.abs(vmc._log_amp_batch(params, configs)) ** 2
        for _ in range(n):
            configs, p = vmc._mh_step(params, configs, p, gen)
        vmc.sampler.configs = configs
        return configs

    runs = []
    for sample in (TNVMC._sample_batch, eager):
        vmc = TNVMC(psi, H, sampler=make(), nchains=32)
        first = sample(vmc, vmc.params, 25)
        vmc.params = [p * 1.1 for p in vmc.params]
        second = sample(vmc, vmc.params, 25)
        runs.append((first, second, vmc._graph))
    assert runs[0][2] is not None and runs[1][2] is None
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    # a new sampler: a new capture, its chains as its own eager steps
    vmc = TNVMC(psi, H, sampler=make(), nchains=32)
    vmc._sample_batch(vmc.params, 25)
    old = vmc._graph
    vmc.sampler = make()
    got = vmc._sample_batch(vmc.params, 25)
    assert vmc._graph[3] is not old[3]
    ref = TNVMC(psi, H, sampler=make(), nchains=32)
    assert torch.equal(got, eager(ref, ref.params, 25))


def test_builders_follow_the_default_dtype_on_card(cuda):
    """Under ``default_dtype`` the builders make tensors of that dtype on
    the card, and the stack unwinds."""
    from quimb_torch.config import default_dtype, get_default_dtype
    from quimb_torch.gen.rand import rand_ket

    with default_dtype("complex64"):
        assert rand_ket(8, seed=1).dtype == torch.complex64
        # random MPS take the real counterpart, as quimb_tpu's
        psi = quimb_torch.MPS_rand_state(6, 4, seed=1)
        assert psi.dtype == torch.float32 and psi[0].data.is_cuda
        with default_dtype("float32"):
            peps = quimb_torch.PEPS.rand(2, 2, 2, seed=1)
            assert peps.dtype == torch.float32 and peps[0, 0].data.is_cuda
            # the circuit's start state is host numpy until a gate
            circ = quimb_torch.Circuit(3)
            assert str(circ.psi.dtype).replace("torch.", "") == "float32"
    assert get_default_dtype() == torch.complex128
    assert quimb_torch.MPS_rand_state(4, 2, seed=1).dtype == torch.float64


@pytest.fixture
def nccl_world(cuda):
    """A one-rank NCCL world on the card (``get_mesh`` starts it),
    destroyed after the test."""
    import torch.distributed as dist
    from quimb_torch.parallel import get_mesh

    mesh = get_mesh()
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("bsz", [2, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sharded_dmrg_on_card_equals_unsharded(nccl_world, dtype, bsz):
    """DMRG under ``shard_onto(get_mesh_2d())`` in a one-rank NCCL world:
    every block is whole, so its sweeps meet the unsharded ones at 1e-12,
    and each of its matvecs launches the dtype's sandwich kernel."""
    from torch.distributed.tensor import Shard

    from quimb_torch.parallel import get_mesh_2d

    L, chi = 16, 32
    H = quimb_torch.MPO_ham_heis(L, dtype=dtype, device="cuda")
    p0 = quimb_torch.MPS_rand_state(L, chi, seed=5, dtype=dtype,
                                    device="cuda")
    ens, launches = {}, {}
    for shard in (True, False):
        dmrg = quimb_torch.DMRG(H, bond_dims=chi, cutoffs=0.0, p0=p0.copy(),
                                bsz=bsz)
        if shard:
            dmrg.shard_onto(get_mesh_2d())
        before = dict(ck.LAUNCHES)
        ens[shard] = [dmrg.sweep(d, max_bond=chi, cutoff=0.0, canonize=c)
                      for d, c in (("R", True), ("L", False), ("R", False))]
        torch.cuda.synchronize()
        launches[shard] = ck.LAUNCHES[_KERNEL[dtype]] - before[_KERNEL[dtype]]
        if shard:
            renv = dmrg._build_right_envs()
            bulk = renv[L // 2]
            assert isinstance(bulk.placements[1], Shard)
            assert all(e.to_local().is_cuda for e in renv if e is not None)
    # the same arithmetic; only the layout of the all-reduced environments
    # (contiguous, as NCCL takes them) can move the last bits
    np.testing.assert_allclose(ens[True], ens[False], rtol=1e-12, atol=0)
    # three sweeps of L - bsz + 1 solves, each of at least 4 matvecs (a
    # one-site space at a chain end has dimension 1 * 2 * 2)
    assert launches[True] == launches[False] >= 4 * 3 * (L - bsz + 1)


def test_sharded_exact_core_on_card(nccl_world):
    """The row-sharded operator in a one-rank NCCL world: its matvec
    against ``SparseHam``, its Lanczos energy and Krylov expm against the
    dense ones."""
    import scipy.linalg as sla

    from quimb_torch import parallel as par

    H = quimb_torch.ham_heis(10, sparse=True)
    Hs = par.ShardedSparseHam(H, mesh=nccl_world)
    assert Hs.V.to_local().is_cuda and Hs.device.type == "cuda"
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(2**10),
                        device="cuda")
    want = core.SparseHam(H).matvec(x)
    got = Hs.matvec(Hs.shard_vector(x))
    assert got.is_cuda
    assert float(torch.max(torch.abs(got - want))) <= 1e-12
    dense = H.toarray()
    lam, _ = par.eigh_lanczos_sharded(Hs, ncv=30, restarts=8)
    assert abs(float(lam) - np.linalg.eigvalsh(dense)[0]) < 1e-9
    v = np.random.default_rng(1).standard_normal(2**10)
    y = par.expm_multiply_sharded(Hs, v, t=-0.4, ncv=40)
    np.testing.assert_allclose(y, sla.expm(-0.4 * dense) @ v, rtol=0,
                               atol=1e-10)


def test_circuit_dense_xeb_and_counts_on_card_match_cpu(cuda):
    """``CircuitBase.xeb`` and ``simulate_counts`` of a 12-qubit dense
    circuit on the card give the CPU's: the same counts from the same
    |psi|^2 and seed, the XEB at 1e-12."""
    out = {}
    for dev in ("cpu", cuda):
        lazy = quimb_torch.circ_ansatz_1D_brickwork(12, 4, seed=3,
                                                    device="cpu")
        c = quimb_torch.CircuitDense(12, device=dev)
        c.apply_gates(lazy.gates)
        strings = list(c.sample(8, seed=6))
        out[str(dev)] = (c.xeb(strings), c.simulate_counts(50, seed=7),
                         strings)
    assert out["cuda"][2] == out["cpu"][2]
    assert out["cuda"][1] == out["cpu"][1]
    assert sum(out["cuda"][1].values()) == 50
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], abs=1e-12)


def test_spin_ham_build_dense_on_card_matches_cpu(cuda):
    """``SpinHam1D.build_dense(10)`` on the card in the default dtype,
    equal to the CPU's and to ``build_sparse``'s host matrix."""
    H = quimb_torch.SpinHam1D(S=1 / 2)
    H += 1.0, "X", "X"
    H += 0.5, "Z", "Z"
    H += 0.2, "Z"
    got = H.build_dense(10)
    assert got.is_cuda and got.dtype == torch.complex128
    want = H.build_dense(10, device="cpu")
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(want.numpy(), H.build_sparse(10).toarray())
