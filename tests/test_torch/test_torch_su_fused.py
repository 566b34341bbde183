"""quimb_torch's fused SimpleUpdate sweeps (``tensor/tn2d/su_fused.py``)
against quimb_tpu's, in float64 on the CPU, on the same stacks.

Both packages build the stacks of one PEPS (carried across with
``convert.from_tpu_peps``) and one gauge dict. A class update's QR and SVD
factors carry a gauge (signs of their columns) that differs between
LAPACK under JAX and under torch, so the updated sites are compared by the
two-site products over the updated bond, which do not depend on it; the
gauge vectors are singular values and are compared directly. Tolerance:
1e-10 relative (float64, one or two batched QR / SVD steps a value).
"""

import numpy as np
import pytest
import torch

import quimb_tpu.tensor as jtn
from quimb_torch import convert
from quimb_torch.ops import decomp
from quimb_torch.tensor import ham_2d_heis
from quimb_torch.tensor.tn2d import su_fused as tf
from quimb_tpu.tensor.tn2d import su_fused as jf

CPU = "cpu"
TOL = 1e-10
LX, LY, D = 3, 4, 2


def _n(x):
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().numpy()
    return np.asarray(x)


def _close(a, b, tol=TOL):
    a, b = _n(a), _n(b)
    return np.linalg.norm(a - b) <= tol * max(np.linalg.norm(b), 1e-300)


def _arrays(Lx, Ly, D, seed):
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal(
        [D] * sum((i < Lx - 1, j < Ly - 1, i > 0, j > 0)) + [2])
        for j in range(Ly)] for i in range(Lx)]


def _gauges(Lx, Ly, D, seed):
    """Decreasing positive unit-norm vectors on every bond."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(Lx):
        for j in range(Ly):
            for b in ((i, j + 1), (i + 1, j)):
                if b[0] < Lx and b[1] < Ly:
                    s = np.sort(rng.uniform(0.1, 1.0, D))[::-1]
                    out[(i, j), b] = s / np.linalg.norm(s)
    return out


def _both_stacks(seed=0, with_gauges=True):
    """quimb_tpu's and the port's (S, GH, GV) of one PEPS and gauge dict."""
    j = jtn.PEPS(_arrays(LX, LY, D, seed), shape="urdlp")
    t = convert.from_tpu_peps(j, device=CPU)
    g = _gauges(LX, LY, D, seed) if with_gauges else {}
    js = jf.peps_to_stacks(j, g, D)
    ts = tf.peps_to_stacks(t, convert.from_tpu_gauges(g, device=CPU), D)
    return js, ts, t


def _gates(Lx, Ly, x):
    ham = ham_2d_heis(Lx, Ly)
    jham = jtn.ham_2d_heis(Lx, Ly)
    return (jf.class_gate_stacks(jham, Lx, Ly, x, 2, np.float64),
            tf.class_gate_stacks(ham, Lx, Ly, x, 2, np.float64, CPU))


def _pair_products(S, cols):
    """sum_c A[..., r=c, ...] B[..., l=c] over the bonds (i, j)-(i, j+1),
    j in ``cols``: (x, y, pA, uA, dA, lA, pB, uB, rB, dB)."""
    S = torch.as_tensor(np.array(_n(S)))
    A = S[:, cols]
    B = S[:, [c + 1 for c in cols]]
    return torch.einsum("xyaucdl,xybvewc->xyaudlbvew", A, B)


@pytest.mark.parametrize("with_gauges", [True, False])
def test_stacks_match(with_gauges):
    """``peps_to_stacks`` gives quimb_tpu's stacks exactly (fresh bonds get
    an identity gauge), and ``stacks_to_peps`` returns the PEPS and the
    gauges."""
    (jS, jGH, jGV), (S, GH, GV), t = _both_stacks(3, with_gauges)
    for a, b in ((S, jS), (GH, jGH), (GV, jGV)):
        assert a.shape == tuple(b.shape)
        assert np.array_equal(_n(a), _n(b))
    psi, gauges = tf.stacks_to_peps(S, GH, GV, t)
    for coo in t.gen_site_coos():
        assert torch.equal(psi[psi.site_tag(*coo)].data,
                           t[t.site_tag(*coo)].data)
    assert set(psi.ind_map) != set() and psi.site_inds == t.site_inds
    want = _gauges(LX, LY, D, 3) if with_gauges else None
    for k, v in gauges.items():
        assert np.array_equal(_n(v), want[k] if want else np.ones(D))


def test_axis_masks_and_gates_match():
    for a, b in zip(tf._axis_masks(LX, LY, 3, torch.float64, CPU),
                    jf._axis_masks(LX, LY, 3, np.float64)):
        assert np.array_equal(_n(a), b)
    jg, tg = _gates(LX, LY, -0.1)
    for a, b in zip(tg, jg):
        assert a.shape == tuple(np.shape(b))
        assert _close(a, b, 1e-14)


@pytest.mark.parametrize("o", [0, 1])
def test_h_class_update_matches(o):
    """One horizontal class update on the same stacks: the gauges of the
    updated bonds and the two-site products over them equal quimb_tpu's;
    the sites it does not touch stay as they were; updated sites have
    unit norm."""
    (jS, jGH, jGV), (S, GH, GV), _ = _both_stacks(5)
    S0 = S.clone()
    jg, tg = _gates(LX, LY, -0.3)
    jS2, jGH2, _ = jf._h_class_update(jS, jGH, jGV, jg[o], o, 1e-6)
    S2, GH2, _ = tf._h_class_update(S, GH, GV, tg[o], o, 1e-6)
    assert _close(GH2, jGH2)
    cols = list(range(o, LY - 1, 2))
    assert _close(_pair_products(S2, cols), _pair_products(jS2, cols))
    touched = set(cols) | {c + 1 for c in cols}
    for c in set(range(LY)) - touched:
        assert torch.equal(S2[:, c], S0[:, c])
    for c in touched:
        norms = torch.linalg.vector_norm(S2[:, c], dim=(1, 2, 3, 4, 5))
        assert torch.allclose(norms, torch.ones_like(norms))


def test_su_sweep_matches():
    """Two full sweeps (both orientations, masks, transposes): every gauge
    equals quimb_tpu's, and so does the state with the gauges absorbed
    (dense, 4 x 3 sites)."""
    (jS, jGH, jGV), (S, GH, GV), t = _both_stacks(7)
    jg, tg = _gates(LX, LY, -0.2)
    mh = tf._axis_masks(LX, LY, D, torch.float64, CPU)
    mv = tf._axis_masks(LY, LX, D, torch.float64, CPU)
    jmh = jf._axis_masks(LX, LY, D, np.float64)
    jmv = jf._axis_masks(LY, LX, D, np.float64)
    S, GH, GV = tf._su_evolve(S, GH, GV, *tg, mh, mv, nsteps=2,
                              smudge=1e-6)
    for _ in range(2):
        jS, jGH, jGV = jf._su_sweep(jS, jGH, jGV, *jg, jmh, jmv, 1e-6)
    assert _close(GH, jGH) and _close(GV, jGV)

    def dense(S, GH, GV):
        psi, gauges = tf.stacks_to_peps(
            *(torch.as_tensor(np.array(_n(x))) for x in (S, GH, GV)), t)
        for (a, b), s in gauges.items():
            ta, tb = psi[psi.site_tag(*a)], psi[psi.site_tag(*b)]
            (ix,) = set(ta.inds) & set(tb.inds)
            ta.multiply_index_diagonal_(ix, torch.sqrt(s))
            tb.multiply_index_diagonal_(ix, torch.sqrt(s))
        return _n(psi.to_dense()).reshape(-1)

    assert _close(dense(S, GH, GV), dense(jS, jGH, jGV))


def test_topd_split_matches():
    """The matmul-only split gives quimb_tpu's factors on the same batch,
    and on a batch with a gap below the top D values it gives the SVD's
    projector and kept weight."""
    rng = np.random.default_rng(11)
    M = rng.standard_normal((3, 2, 8, 6))
    U, s, V = tf._topd_split(torch.as_tensor(M), 3)
    jU, js, jV = jf._topd_split(M, 3)
    for a, b in ((U, jU), (s, js), (V, jV)):
        assert _close(a, b)
    # a gap below the top three values
    Q1, _ = np.linalg.qr(rng.standard_normal((8, 8)))
    Q2, _ = np.linalg.qr(rng.standard_normal((6, 6)))
    sv = np.array([10.0, 8.0, 6.0, 0.5, 0.3, 0.1])
    M = (Q1[:, :6] * sv) @ Q2
    U, s, V = tf._topd_split(torch.as_tensor(M), 3)
    # the subspace converges at (0.5 / 6)^2 a step: its projector and the
    # weight in it are the SVD's (the values inside it converge more
    # slowly, at (8 / 10)^2 a step, so they are not compared)
    P = _n(U) @ _n(U).T
    assert np.allclose(P, Q1[:, :3] @ Q1[:, :3].T, atol=1e-10)
    assert abs(float((s ** 2).sum()) - float((sv[:3] ** 2).sum())) < 1e-10


def test_mgs_cols_matches():
    rng = np.random.default_rng(12)
    Y = rng.standard_normal((4, 7, 3))
    Q = tf._mgs_cols(torch.as_tensor(Y))
    assert _close(Q, jf._mgs_cols(Y))
    QtQ = _n(Q.mT @ Q)
    assert np.allclose(QtQ, np.broadcast_to(np.eye(3), QtQ.shape))


def test_bond_svd_on_the_cpu_is_lapack():
    """On the CPU the bond split is LAPACK's SVD, redoing nothing."""
    rng = np.random.default_rng(13)
    M = torch.as_tensor(rng.standard_normal((2, 3, 12, 12)))
    before = dict(decomp.SVD_REDOS)
    U, s, VH = tf._bond_svd(M)
    assert _close((U * s[..., None, :]) @ VH, M, 1e-13)
    assert decomp.SVD_REDOS == before
