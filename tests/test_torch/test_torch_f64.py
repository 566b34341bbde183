"""The float64 sandwich kernel's layout and order of sums, on the CPU, and
the float64 DMRG2 path that drives it.

The FP64 tensor-core kernel (``quimb_torch/csrc/sandwich_f64.cu``) runs
only on a GPU. What surrounds it is plain torch and is held here against
quimb_tpu: the padded stacks of ``sandwich_layout``, theta padded and
transposed as the kernel's first launch writes it, the two passes per x
and the sum over x in the kernel's order. The Pallas kernel sums in a
float32 scratch even for float64 inputs (a TPU limit), so the reference
is quimb_tpu's plain ``sandwich_matvec_reference``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quimb_tpu.tensor as qtn
import quimb_torch
from quimb_tpu.ops import pallas_kernels as pk
from quimb_tpu.tensor.tn1d import dmrg as jd
from quimb_torch.convert import from_tpu_mpo, from_tpu_mps
from quimb_torch.ops import cuda_kernels as ck
from quimb_torch.tensor.tn1d import dmrg as td

# (w, M, K1, K2, N): the north-star bond (5, 512, 512, 512, 512) cut to
# narrow widths, a ragged shape that leaves partial tiles on every edge, a
# small odd one and 1 x 1 bonds
SHAPES = [(5, 64, 64, 64, 64), (5, 130, 66, 98, 34), (3, 7, 5, 9, 3),
          (1, 1, 1, 1, 1)]


def _operands(rng, w, M, K1, K2, N):
    return (rng.standard_normal((w, M, K1)), rng.standard_normal((K1, K2)),
            rng.standard_normal((w, K2, N)))


def _kernel_order(a, theta, b):
    """The float64 kernel's matvec in plain torch: the stacks laid out
    once, theta transposed and zero-padded to (K2p, K1p), pass 1 and
    pass 2 per x, then the partial sums added in order of x."""
    w, M, K1 = a.shape
    K2, N = b.shape[1:]
    ap, bp = ck.sandwich_layout(a, b)
    _, K1p, K2p, _ = ck.sandwich_padded_dims(M, K1, K2, N)
    theta_t = theta.new_zeros((K2p, K1p))
    theta_t[:K2, :K1] = theta.T
    out = None
    for x in range(w):
        t = ap[x] @ theta_t.T          # pass 1: T[x] = A[x] . theta_t^T
        part = t @ bp[x].T             # pass 2: P[x] = T[x] . B[x]
        out = part if out is None else out + part
    return out[:M, :N], (ap, bp)


@pytest.mark.parametrize("shape", SHAPES)
def test_f64_layout_matches_pallas_reference(shape):
    w, M, K1, K2, N = shape
    a, theta, b = _operands(np.random.default_rng(7), *shape)
    got, (ap, bp) = _kernel_order(*map(torch.from_numpy, (a, theta, b)))
    Mp, K1p, K2p, Np = ck.sandwich_padded_dims(M, K1, K2, N)
    # whole tiles of the float64 kernel (64 x 64 output tiles, 16-deep
    # stages) in both passes
    assert Mp % 128 == 0 and Np % 128 == 0
    assert K1p % 32 == 0 and K2p % 64 == 0
    assert ap.dtype == bp.dtype == torch.float64
    assert ap[:, M:].abs().sum() == 0 and ap[:, :, K1:].abs().sum() == 0
    assert bp[:, N:].abs().sum() == 0 and bp[:, :, K2:].abs().sum() == 0
    want = np.asarray(pk.sandwich_matvec_reference(
        jnp.asarray(a), jnp.asarray(theta), jnp.asarray(b)))
    # float64 sums over at most 5 * 130 terms, in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= 1e-12


def test_f64_local_solve_prepares_once_per_solve():
    """At a chain-end bond (left bond 1) in float64, the local solve
    prepares the stacks once and applies them at every Lanczos matvec,
    and the result is the one-shot matvec's and quimb_tpu's."""
    rng = np.random.default_rng(8)
    cl, cr, d, w = 1, 4, 2, 5
    L = torch.from_numpy(rng.normal(size=(cl, w, cl)))
    W1 = torch.from_numpy(rng.normal(size=(w, w, d, d)))
    W2 = torch.from_numpy(rng.normal(size=(w, w, d, d)))
    R = torch.from_numpy(rng.normal(size=(cr, w, cr)))
    theta0 = torch.from_numpy(rng.normal(size=(cl, d, d, cr)))
    calls = {"prepare": 0, "apply": 0}

    def prepare(a, b):
        assert a.dtype == b.dtype == torch.float64
        calls["prepare"] += 1
        heff = ck.prepare_sandwich(a, b)

        def apply(theta):
            calls["apply"] += 1
            return heff(theta)
        return apply

    kw = dict(ncv=8, restarts=2, norm_energy=False)
    en, v = td._local_solve_2site(L, W1, W2, R, theta0, sandwich=prepare,
                                  **kw)
    assert calls == {"prepare": 1, "apply": 16}
    en_ref, v_ref = td._local_solve_2site(L, W1, W2, R, theta0, **kw)
    assert en.item() == en_ref.item() and torch.equal(v, v_ref)

    A, B = td._sandwich_operands(L, W1, W2, R)
    th = theta0.reshape(A.shape[2], B.shape[1])
    got, _ = _kernel_order(A, th, B)
    want = np.asarray(jd._heff_matvec_2site(
        jd._fuse_lw(jnp.asarray(L.numpy()), jnp.asarray(W1.numpy())),
        jd._fuse_wr(jnp.asarray(W2.numpy()), jnp.asarray(R.numpy())),
        jnp.asarray(theta0.numpy())))
    # float64 sums over at most w * d * cr terms
    np.testing.assert_allclose(got.reshape(theta0.shape).numpy(), want,
                               rtol=1e-12, atol=1e-12)


def test_f64_sweep_prepares_once_per_bond():
    """A float64 DMRG2 sweep resolves the prepare step once, prepares once
    per bond and applies ncv * restarts matvecs per bond: the count that
    chip_smoke.py holds the float64 kernel's launches to. Its energies are
    quimb_tpu's."""
    L, chi = 10, 32
    H = qtn.MPO_ham_heis(L)
    p0 = qtn.MPS_rand_state(L, chi, seed=9)
    jdmrg = qtn.DMRG2(H, bond_dims=chi, cutoffs=0.0, p0=p0)
    tdmrg = quimb_torch.DMRG2(from_tpu_mpo(H, device="cpu"), bond_dims=chi,
                              cutoffs=0.0, p0=from_tpu_mps(p0, device="cpu"))
    assert tdmrg._sandwich is ck.prepare_sandwich_reference
    assert all(t.dtype == torch.float64 for t in tdmrg.state)
    calls = {"prepare": 0, "apply": 0}
    resolved = tdmrg._sandwich

    def prepare(a, b):
        calls["prepare"] += 1
        heff = resolved(a, b)

        def apply(theta):
            calls["apply"] += 1
            return heff(theta)
        return apply

    tdmrg._sandwich = prepare
    opts = tdmrg.opts
    ncv = max(2 * opts["local_eig_ncv"], opts["local_eig_ncv_floor"])
    per_sweep = ncv * opts["local_eig_restarts"] * (L - 1)
    for i, (direction, canonize) in enumerate([("R", True), ("L", False)]):
        kw = dict(max_bond=chi, cutoff=0.0, canonize=canonize)
        t_en = tdmrg.sweep(direction, **kw)
        j_en = jdmrg.sweep(direction, **kw)
        assert calls == {"prepare": (i + 1) * (L - 1),
                         "apply": (i + 1) * per_sweep}
        # float64 Lanczos and SVD from one state, with no truncation
        assert abs(t_en - j_en) < 1e-9


def test_f64_prepare_rejects_cpu_before_any_build():
    """A CPU tensor never reaches the float64 kernel: its prepare step
    raises before anything is built, and the plain version serves the
    CPU."""
    a = torch.ones((2, 3, 3), dtype=torch.float64)
    b = torch.ones((2, 3, 5), dtype=torch.float64)
    with pytest.raises(ValueError):
        ck.prepare_sandwich_f64(a, b)
    assert ck._library.cache_info().currsize == 0
    assert ck.resolve_sandwich("cpu", torch.float64) is \
        ck.prepare_sandwich_reference
    assert ck.resolve_sandwich("cuda", torch.float64) is \
        ck.prepare_sandwich_f64
