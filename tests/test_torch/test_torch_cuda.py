"""quimb_torch on a CUDA GPU: the hand-written sandwich kernel against
its plain version, and a small DMRG2 run against the CPU port.

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

# (w, M, K1, K2, N): the bulk bond at chi=256, a bond next to a chain
# end, a ragged shape, and 1 x 1 bonds
SHAPES = [(5, 512, 512, 512, 512), (5, 4, 4, 512, 512),
          (5, 130, 66, 98, 34), (1, 1, 1, 1, 1)]


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
    rng = np.random.default_rng(0)
    host = (rng.standard_normal((w, M, K1)), rng.standard_normal((K1, K2)),
            rng.standard_normal((w, K2, N)))
    ref = ck.sandwich_matvec_reference(
        *(torch.as_tensor(x, device=cuda) for x in host))
    before = ck.SANDWICH_LAUNCHES
    got = ck.sandwich_matvec(
        *(torch.as_tensor(x, dtype=dtype, device=cuda) for x in host))
    torch.cuda.synchronize()
    assert ck.SANDWICH_LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == (M, N)
    # relative Frobenius error against float64: sums over depths up to
    # 5 * 512 in the operands' precision
    rel = torch.linalg.norm(got.double() - ref) / torch.linalg.norm(ref)
    assert rel.item() <= tol


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
