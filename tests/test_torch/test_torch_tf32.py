"""The float32 sandwich kernel's layout and arithmetic, on the CPU.

The 3xTF32 kernel (``quimb_torch/csrc/sandwich_tf32.cu``) runs only on a
GPU. What surrounds it is plain torch and is held here against quimb_tpu:
the padded, transposed stacks of ``sandwich_layout``, the big/small split
of ``tf32_split``, and a torch emulation of the kernel's 3xTF32 products
that argues the float32 tolerance before any chip run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quimb_tpu.ops import pallas_kernels as pk
from quimb_tpu.tensor.tn1d import dmrg as jd
from quimb_torch.ops import cuda_kernels as ck
from quimb_torch.tensor.tn1d import dmrg as td

# (w, M, K1, K2, N): ragged, a chain end (M = K1 = 2), 1 x 1 bonds, a
# tile-aligned one and widths that are no multiple of 4
SHAPES = [(5, 16, 16, 24, 24), (5, 2, 2, 8, 8), (1, 1, 1, 1, 1),
          (3, 130, 66, 98, 34), (2, 128, 32, 64, 128), (4, 7, 5, 9, 3)]


def _operands(rng, w, M, K1, K2, N):
    return (rng.standard_normal((w, M, K1)), rng.standard_normal((K1, K2)),
            rng.standard_normal((w, K2, N)))


def _padded_theta(theta, K1p, K2p):
    out = theta.new_zeros((K1p, K2p))
    out[:theta.shape[0], :theta.shape[1]] = theta
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_layout_matches_pallas_reference(shape):
    """The padded stacks, contracted by plain torch the way the kernel
    contracts them, give quimb_tpu's reference on the unpadded inputs."""
    w, M, K1, K2, N = shape
    a, theta, b = _operands(np.random.default_rng(3), *shape)
    ap, bp = ck.sandwich_layout(torch.from_numpy(a), torch.from_numpy(b))
    Mp, K1p, K2p, Np = ck.sandwich_padded_dims(M, K1, K2, N)
    assert ap.shape == (w, Mp, K1p) and bp.shape == (w, Np, K2p)
    assert Mp % 128 == 0 and Np % 128 == 0
    assert K1p % 32 == 0 and K2p % 64 == 0
    # the padding is zero, and b is stored transposed (K-major)
    assert ap[:, M:].abs().sum() == 0 and ap[:, :, K1:].abs().sum() == 0
    assert bp[:, N:].abs().sum() == 0 and bp[:, :, K2:].abs().sum() == 0
    np.testing.assert_array_equal(bp[:, :N, :K2].numpy(),
                                  b.transpose(0, 2, 1))

    thp = _padded_theta(torch.from_numpy(theta), K1p, K2p)
    # pass 1 as the kernel lays it out: T_x^T = theta^T . A[x]^T
    t = torch.einsum("lk,xmk->xlm", thp.T, ap)
    # pass 2: P[x] = T_x . B[x], then the sum over x
    got = torch.einsum("xlm,xnl->mn", t, bp)[:M, :N]
    want = np.asarray(pk.sandwich_matvec_reference(
        jnp.asarray(a), jnp.asarray(theta), jnp.asarray(b)))
    # float64 sums over at most 5 * 130 terms
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def _rna_tf32(x):
    """tf32(x), rounded to nearest with ties away from zero, computed
    from the float64 value: keep 11 significant bits."""
    x = x.astype(np.float64)
    m, e = np.frexp(x)                     # x = m 2^e, 0.5 <= |m| < 1
    q = np.sign(m) * np.floor(np.abs(m) * 2**11 + 0.5)
    return np.ldexp(q / 2**11, e).astype(np.float32)


def test_tf32_split_reconstructs():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(20000)
         * 10.0 ** rng.uniform(-20, 20, 20000)).astype(np.float32)
    # exact ties (the 12th significant bit alone set), both signs
    ties = np.array([1 + 2**-11, -(1 + 2**-11), 0.5 + 2**-12],
                    dtype=np.float32)
    x = np.concatenate([x, ties, [0.0, -0.0, 1.0]]).astype(np.float32)
    big, small = ck.tf32_split(torch.from_numpy(x)).numpy()
    for h in (big, small):
        assert not (h.view(np.int32) & 0x1FFF).any(), "not tf32"
    np.testing.assert_array_equal(big, _rna_tf32(x))
    np.testing.assert_array_equal(big[-6:-3], np.array(
        [1 + 2**-10, -(1 + 2**-10), 0.5 + 2**-11], dtype=np.float32))
    np.testing.assert_array_equal(small, _rna_tf32(x - big))
    err = np.abs(big.astype(np.float64) + small - x.astype(np.float64))
    assert (err <= 2.0**-21 * np.abs(x.astype(np.float64))).all()


def _tf32_product(a, b):
    """a @ b in 3xTF32 as the kernel forms it: the two small terms, then
    big . big, all in float32."""
    ah, al = ck.tf32_split(a)
    bh, bl = ck.tf32_split(b)
    return (al @ bh + ah @ bl) + ah @ bh


@pytest.mark.parametrize("shape", [(5, 128, 128, 128, 128),
                                   (3, 130, 66, 98, 34)])
def test_3xtf32_emulation_accuracy(shape):
    """The kernel's arithmetic, emulated in float32 on the CPU, stays
    within the chip tolerance (1e-5 relative Frobenius) of float64, where
    one plain TF32 product does not."""
    w, M, K1, K2, N = shape
    a, theta, b = _operands(np.random.default_rng(5), *shape)
    ref = ck.sandwich_matvec_reference(*map(torch.from_numpy,
                                            (a, theta, b)))
    ap, bp = ck.sandwich_layout(torch.from_numpy(a).float(),
                                torch.from_numpy(b).float())
    Mp, K1p, K2p, Np = ck.sandwich_padded_dims(M, K1, K2, N)
    thp = _padded_theta(torch.from_numpy(theta).float(), K1p, K2p)
    # pass 1 per x, T split by the epilogue; pass 2 per x; the sum over x
    parts = [_tf32_product(_tf32_product(thp.T, ap[x].T).T, bp[x].T)
             for x in range(w)]
    got = torch.stack(parts).sum(0)[:M, :N]
    rel = (torch.linalg.norm(got.double() - ref)
           / torch.linalg.norm(ref)).item()
    assert rel <= 1e-5

    def one_pass(u, v):
        return ck.tf32_split(u)[0] @ ck.tf32_split(v)[0]

    plain = torch.stack([one_pass(one_pass(ap[x], thp), bp[x].T)
                         for x in range(w)]).sum(0)[:M, :N]
    rel_plain = (torch.linalg.norm(plain.double() - ref)
                 / torch.linalg.norm(ref)).item()
    assert rel_plain > 1e-4


def test_local_solve_prepares_once_per_solve():
    """The local solve prepares the stacks once and applies them at every
    Lanczos matvec, and the result is the one-shot matvec's."""
    rng = np.random.default_rng(6)
    cl, cr, d, w = 4, 3, 2, 5
    L = torch.from_numpy(rng.normal(size=(cl, w, cl)))
    W1 = torch.from_numpy(rng.normal(size=(w, w, d, d)))
    W2 = torch.from_numpy(rng.normal(size=(w, w, d, d)))
    R = torch.from_numpy(rng.normal(size=(cr, w, cr)))
    theta0 = torch.from_numpy(rng.normal(size=(cl, d, d, cr)))
    calls = {"prepare": 0, "apply": 0}

    def prepare(a, b):
        calls["prepare"] += 1
        heff = ck.prepare_sandwich(a, b)

        def apply(theta):
            calls["apply"] += 1
            return heff(theta)
        return apply

    kw = dict(ncv=6, restarts=2, norm_energy=False)
    en, v = td._local_solve_2site(L, W1, W2, R, theta0, sandwich=prepare,
                                  **kw)
    assert calls == {"prepare": 1, "apply": 12}
    en_ref, v_ref = td._local_solve_2site(L, W1, W2, R, theta0, **kw)
    assert en.item() == en_ref.item() and torch.equal(v, v_ref)

    A, B = td._sandwich_operands(L, W1, W2, R)
    th = theta0.reshape(A.shape[2], B.shape[1])
    heff = ck.prepare_sandwich(A, B)
    assert torch.equal(heff(th), ck.sandwich_matvec(A, th, B))
    want = np.asarray(jd._heff_matvec_2site(
        jd._fuse_lw(jnp.asarray(L.numpy()), jnp.asarray(W1.numpy())),
        jd._fuse_wr(jnp.asarray(W2.numpy()), jnp.asarray(R.numpy())),
        jnp.asarray(theta0.numpy())))
    # float64 sums over at most w * d * cr terms
    np.testing.assert_allclose(heff(th).reshape(theta0.shape).numpy(), want,
                               rtol=1e-12, atol=1e-12)


def test_prepare_rejects_before_any_build():
    """The prepare steps check the stacks before building anything."""
    a = torch.ones((2, 3, 3), device="meta")
    b = torch.ones((2, 4, 5), device="meta")
    with pytest.raises(ValueError):
        ck.prepare_sandwich(a, b)
    with pytest.raises(ValueError):
        ck.prepare_sandwich_tf32(torch.ones((2, 3, 3)), torch.ones((2, 4, 5)))
    with pytest.raises(ValueError):
        ck.sandwich_layout(torch.ones((2, 3, 3)), torch.ones((3, 4, 5)))
