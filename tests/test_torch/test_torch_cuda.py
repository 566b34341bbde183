"""quimb_torch on a CUDA GPU: the hand-written sandwich kernels (3xTF32
for float32, FP64 tensor cores for float64) against their plain version,
small DMRG2, DMRG1, ParallelDMRG and TEBD runs against the CPU port, the
checked complex SVD, the exact layer's matvecs and solvers, the object
layer and a circuit's amplitudes and samples.

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
