"""quimb_torch's sandwich matvec against quimb_tpu's Pallas kernel.

The Pallas kernel runs in interpret mode on the CPU, as
``tests/test_ops/test_pallas_kernels.py`` runs it. The port's CUDA
kernel cannot run here; its wrapper routes CPU tensors to the plain
einsum, which is what these tests hold against quimb_tpu.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quimb_tpu.ops import pallas_kernels as pk
from quimb_tpu.tensor.tn1d import dmrg as jd
from quimb_torch.ops import cuda_kernels as ck
from quimb_torch.tensor.tn1d import dmrg as td


def _operands(rng, w, M, K1, K2, N, dtype):
    return tuple(rng.normal(size=s).astype(dtype)
                 for s in ((w, M, K1), (K1, K2), (w, K2, N)))


@pytest.mark.parametrize("w,M,K1,K2,N", [
    (5, 16, 16, 24, 24),
    (3, 8, 8, 8, 8),
    (1, 32, 16, 16, 8),
])
def test_reference_matches_pallas(w, M, K1, K2, N):
    ops = _operands(np.random.default_rng(0), w, M, K1, K2, N, np.float32)
    got = ck.sandwich_matvec_reference(*map(torch.from_numpy, ops))
    jops = tuple(map(jnp.asarray, ops))
    # float32 sums over depths <= 24: the tolerance of the Pallas test
    for want in (pk.sandwich_matvec(*jops, interpret=True),
                 pk.sandwich_matvec_reference(*jops)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("cl,cr", [(6, 7), (1, 4), (4, 1)])
def test_operands_match_heff_2site(cl, cr):
    """The (A, B) layouts the port's local solve hands the kernel give
    quimb_tpu's 2-site matvec. W1 and W2 are random and not symmetric,
    so a transposed layout cannot pass."""
    rng = np.random.default_rng(1)
    d, w = 2, 5
    L = rng.normal(size=(cl, w, cl))
    W1 = rng.normal(size=(w, w, d, d))
    W2 = rng.normal(size=(w, w, d, d))
    R = rng.normal(size=(cr, w, cr))
    theta = rng.normal(size=(cl, d, d, cr))

    want = np.asarray(jd._heff_matvec_2site(
        jd._fuse_lw(jnp.asarray(L), jnp.asarray(W1)),
        jd._fuse_wr(jnp.asarray(W2), jnp.asarray(R)), jnp.asarray(theta),
    ))
    tL, tW1, tW2, tR, tth = map(torch.from_numpy, (L, W1, W2, R, theta))
    A, B = td._sandwich_operands(tL, tW1, tW2, tR)
    assert A.is_contiguous() and B.is_contiguous()
    assert A.shape == (w, cl * d, cl * d) and B.shape == (w, d * cr, d * cr)
    got = ck.sandwich_matvec(A, tth.reshape(cl * d, d * cr), B)
    # float64 sums over at most w * d * cr terms
    np.testing.assert_allclose(got.reshape(theta.shape).numpy(), want,
                               rtol=1e-12, atol=1e-12)
    chain = td._heff_matvec_2site(td._fuse_lw(tL, tW1),
                                  td._fuse_wr(tW2, tR), tth)
    np.testing.assert_allclose(chain.numpy(), want, rtol=1e-12, atol=1e-12)


def test_wrapper_takes_plain_version_on_cpu():
    ops = tuple(map(torch.from_numpy, _operands(
        np.random.default_rng(2), 5, 12, 12, 10, 10, np.float64)))
    before = dict(ck.LAUNCHES)
    got = ck.sandwich_matvec(*ops)
    assert torch.equal(got, ck.sandwich_matvec_reference(*ops))
    assert ck.LAUNCHES == before


def test_resolve_sandwich():
    assert ck.resolve_sandwich("cpu", torch.float32) is \
        ck.prepare_sandwich_reference
    assert ck.resolve_sandwich("cpu", torch.complex128) is \
        ck.prepare_sandwich_reference
    assert ck.resolve_sandwich("cuda", torch.float32) is \
        ck.prepare_sandwich_tf32
    assert ck.resolve_sandwich("cuda", torch.float64) is \
        ck.prepare_sandwich_f64
    # complex operands take the plain product on CUDA too, as quimb_tpu's
    # use_sandwich_kernel sends them to its einsum
    for dtype in (torch.complex64, torch.complex128):
        assert ck.resolve_sandwich("cuda", dtype) is \
            ck.prepare_sandwich_reference
    with pytest.raises(TypeError):
        ck.resolve_sandwich("cuda", torch.float16)


def test_wrapper_raises_off_cpu_and_cuda():
    a = torch.empty((2, 3, 3), device="meta")
    th = torch.empty((3, 4), device="meta")
    b = torch.empty((2, 4, 5), device="meta")
    with pytest.raises(ValueError):
        ck.sandwich_matvec(a, th, b)
