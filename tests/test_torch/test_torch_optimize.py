"""quimb_torch's ``TNOptimizer`` (``tensor/optimize.py``) against quimb_tpu's,
and its first-order rules against optax, on the CPU in float64 and
complex128.

The loss is the Rayleigh quotient <psi|H|psi> / <psi|psi> of a small
Heisenberg MPO, contracted site by site by the same einsums in both
packages, from one set of numpy arrays. Tolerances: 1e-10 relative on
each loss of an L-BFGS-B run (the same scipy driver on gradients equal to
round-off), 1e-12 on the packed gradient and Hessian-vector product
against quimb_tpu's, and 1e-12 relative on each rule's parameters after
a few steps against optax's own update (one set of formulas; round-off).
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import quimb_torch.tensor as ttn
import quimb_tpu.tensor as jtn
from quimb_torch import convert
from quimb_torch.tensor import optimize as topt

L, CHI = 6, 4
RULES = sorted(topt._OPTAX_METHODS)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def start_arrays(dtype="float64", seed=42):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(L):
        chil, chir = min(CHI, 2**i, 2**(L - i)), min(CHI, 2**(i + 1),
                                                     2**(L - i - 1))
        shape = ([chil] if i else []) + ([chir] if i < L - 1 else []) + [2]
        x = rng.standard_normal(shape)
        if dtype == "complex128":
            x = x + 1j * rng.standard_normal(shape)
        out.append(x / 2)
    return out


def _padded(arrays):
    return [arrays[0][None]] + list(arrays[1:-1]) + [arrays[-1][:, None]]


def rayleigh(psi, Ws, xp):
    As = _padded([psi[psi.site_tag(i)].data for i in range(psi.L)])
    env = xp.ones((1, 1, 1), dtype=As[0].dtype)
    nrm = xp.ones((1, 1), dtype=As[0].dtype)
    for A, W in zip(As, Ws):
        T = xp.einsum("awb,brp->awrp", env, A)
        T = xp.einsum("awrp,wxqp->axrq", T, W.astype(A.dtype) if xp is jnp
                      else W.to(A.dtype))
        env = xp.einsum("axrq,asq->sxr", T, A.conj())
        nrm = xp.einsum("arp,asp->sr", xp.einsum("ab,brp->arp", nrm, A),
                        A.conj())
    return (env.reshape(()) / nrm.reshape(())).real


@pytest.fixture(scope="module")
def heis():
    jH = jtn.MPO_ham_heis(L)
    Ws = _padded([np.array(t.data) for t in jH])
    return [jnp.asarray(w) for w in Ws], [torch.as_tensor(w) for w in Ws]


def pair(heis, dtype="float64", seed=42):
    arrays = start_arrays(dtype, seed)
    jpsi = jtn.MatrixProductState([jnp.asarray(a) for a in arrays],
                                  shape="lrp")
    tpsi = ttn.MatrixProductState([torch.as_tensor(a) for a in arrays],
                                  shape="lrp")
    jW, tW = heis
    return (jpsi, lambda psi: rayleigh(psi, jW, jnp),
            tpsi, lambda psi: rayleigh(psi, tW, torch))


@pytest.fixture(scope="module")
def lbfgsb_runs(heis):
    out = {}
    for dtype in ("float64", "complex128"):
        jpsi, jl, tpsi, tl = pair(heis, dtype)
        oj = jtn.TNOptimizer(jpsi, jl, progbar=False)
        oj.optimize(5)
        ot = ttn.TNOptimizer(tpsi, tl, progbar=False)
        out[dtype] = (oj, ot, ot.optimize(5))
    return out


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_lbfgsb_losses_match(lbfgsb_runs, dtype):
    oj, ot, tn = lbfgsb_runs[dtype]
    a, b = np.array(oj.losses), np.array(ot.losses)
    assert len(a) == len(b) and ot.nevals == len(b)
    assert np.max(np.abs(a - b) / np.abs(a)) <= 1e-10
    assert b[-1] < b[0]
    assert isinstance(tn, ttn.MatrixProductState)
    assert not any(t.data.requires_grad for t in tn)


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_packed_gradient_and_hessp_match(heis, dtype):
    """The packed gradient equals quimb_tpu's, whose JAX gradient it
    conjugates: torch's gradient of a real loss is that already."""
    jpsi, jl, tpsi, tl = pair(heis, dtype, seed=3)
    oj = jtn.TNOptimizer(jpsi, jl, progbar=False)
    ot = ttn.TNOptimizer(tpsi, tl, progbar=False)
    oj._vectorizer = jtn.Vectorizer(oj.params)
    ot._vectorizer = ttn.Vectorizer(ot.params)
    oj._pbar = None
    x = oj._vectorizer.pack(oj.params)
    np.testing.assert_array_equal(x, ot._vectorizer.pack(ot.params))
    assert ot.d == oj.d == x.size
    vj, gj = oj.vectorized_value_and_grad(x)
    vt, gt = ot.vectorized_value_and_grad(x)
    assert abs(vj - vt) <= 1e-12 * abs(vj)
    assert np.linalg.norm(gj - gt) <= 1e-12 * np.linalg.norm(gj)
    p = np.random.default_rng(0).standard_normal(x.size)
    hj, ht = oj.vectorized_hessp(x, p), ot.vectorized_hessp(x, p)
    assert np.linalg.norm(hj - ht) <= 1e-12 * np.linalg.norm(hj)
    assert abs(ot.vectorized_value(x) - vj) <= 1e-12 * abs(vj)


def test_gradient_matches_finite_differences(heis):
    """autograd through the port's own contraction (``TensorNetwork``
    ``@``, ``contract`` by the path finder and ``tensor_contract``): an
    in-place update, a host read or a dropped intermediate there would
    break it. Central differences of step 1e-6 in float64: 1e-6
    relative."""
    _, _, tpsi, _ = pair(heis, "complex128", seed=5)
    jH = jtn.MPO_ham_heis(L)
    tH = convert.from_tpu_mpo(jH, device="cpu")

    def loss(psi):
        bra = psi.H.reindex({f"k{i}": f"b{i}" for i in range(L)})
        num = (bra & tH & psi).contract(..., optimize="auto")
        return (num / (psi.H @ psi)).real

    opt = ttn.TNOptimizer(tpsi, loss, progbar=False)
    opt._vectorizer = ttn.Vectorizer(opt.params)
    x = opt._vectorizer.pack(opt.params)
    _, g = opt.vectorized_value_and_grad(x)
    rng = np.random.default_rng(1)
    h = 1e-6
    for _ in range(3):
        p = rng.standard_normal(x.size)
        fd = (opt.vectorized_value(x + h * p)
              - opt.vectorized_value(x - h * p)) / (2 * h)
        assert abs(fd - g @ p) <= 1e-6 * abs(g @ p)


def test_newton_cg_uses_hessp(heis):
    """Newton-CG as quimb_tpu's own test calls it (``optimize(n,
    method="Newton-CG")``, the Hessian-vector product given): the losses
    follow quimb_tpu's to 1e-10."""
    jpsi, jl, tpsi, tl = pair(heis, seed=9)
    oj = jtn.TNOptimizer(jpsi, jl, progbar=False)
    ot = ttn.TNOptimizer(tpsi, tl, progbar=False)
    oj._vectorizer = jtn.Vectorizer(oj.params)
    oj._pbar = None
    from scipy.optimize import minimize

    x0 = oj._vectorizer.pack(oj.params)
    minimize(oj.vectorized_value_and_grad, x0, jac=True,
             hessp=oj.vectorized_hessp, method="Newton-CG",
             options={"maxiter": 3})
    ot.optimize(3, method="Newton-CG")
    a, b = np.array(oj.losses), np.array(ot.losses)
    assert len(a) == len(b)
    assert np.max(np.abs(a - b) / np.abs(a)) <= 1e-10


def test_scipy_methods_and_basinhopping(heis):
    _, _, tpsi, tl = pair(heis, seed=11)
    for method in ("TNC", "CG", "BFGS"):
        ot = ttn.TNOptimizer(tpsi, tl, optimizer=method, progbar=False)
        ot.optimize(4)
        assert ot.losses[-1] < ot.losses[0]
    ot = ttn.TNOptimizer(tpsi, tl, progbar=False)
    out = ot.optimize_basinhopping(3, 2)
    assert min(ot.losses) < ot.losses[0]
    assert isinstance(out, ttn.MatrixProductState)


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
@pytest.mark.parametrize("rule", RULES)
def test_rule_matches_optax(rule, dtype):
    """Each of quimb_tpu's optax names, with optax's defaults, as a plain
    tensor update: four steps on a quartic loss of two parameter arrays,
    against optax 0.2.6 fed the same (conjugated JAX, i.e. torch's)
    gradient, as quimb_tpu's optimizer feeds it."""
    rng = np.random.default_rng(RULES.index(rule))
    shapes = ((3, 4), (5,))
    ps = [rng.standard_normal(s) + (1j * rng.standard_normal(s)
                                    if dtype == "complex128" else 0)
          for s in shapes]
    lr = 0.05

    def loss_t(ps):
        return sum(torch.sum(torch.abs(p) ** 4) - torch.sum(p.real)
                   for p in ps)

    def loss_j(ps):
        return sum(jnp.sum(jnp.abs(p) ** 4) - jnp.sum(p.real) for p in ps)

    opt = getattr(optax, rule)(lr)
    jp = [jnp.asarray(p) for p in ps]
    state = opt.init(jp)
    import jax

    grad_j = jax.grad(loss_j)
    r = topt._Rule(rule, lr)
    tp = [torch.as_tensor(p) for p in ps]
    r.init(tp)
    for _ in range(4):
        g = [jnp.conj(x) for x in grad_j(jp)]
        upd, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        leaves = [p.detach().requires_grad_(True) for p in tp]
        gt = torch.autograd.grad(loss_t(leaves), leaves)
        tp = r.step(tp, list(gt))
    for a, b in zip(jp, tp):
        a = np.asarray(a)
        assert np.linalg.norm(a - b.numpy()) <= 1e-12 * np.linalg.norm(a)


def test_complex_adam_through_tnoptimizer(heis):
    """Adam on complex parameters keeps optax's |g|^2 moment, so the
    losses follow quimb_tpu's (torch.optim.Adam would not)."""
    jpsi, jl, tpsi, tl = pair(heis, "complex128", seed=13)
    oj = jtn.TNOptimizer(jpsi, jl, optimizer="adam", learning_rate=0.05,
                         progbar=False)
    ot = ttn.TNOptimizer(tpsi, tl, optimizer="adam", learning_rate=0.05,
                         progbar=False)
    oj.optimize(5)
    ot.optimize(5)
    a, b = np.array(oj.losses), np.array(ot.losses)
    assert np.max(np.abs(a - b) / np.abs(a)) <= 1e-12


def test_tags_shared_and_constant(heis):
    """``tags``, ``shared_tags`` and ``constant_tags`` select the same
    parameters as quimb_tpu's, and a constant tensor stays as it was."""
    jpsi, jl, tpsi, tl = pair(heis, seed=17)
    opts = dict(tags=[tpsi.site_tag(i) for i in range(1, 5)],
                constant_tags=[tpsi.site_tag(1)])
    oj = jtn.TNOptimizer(jpsi, jl, progbar=False, **opts)
    ot = ttn.TNOptimizer(tpsi, tl, progbar=False, **opts)
    assert ot.d == oj.d
    out = ot.optimize(3)
    oj.optimize(3)
    np.testing.assert_allclose(ot.losses, oj.losses, rtol=1e-10)
    for i in (0, 1, 5):
        assert torch.equal(out[out.site_tag(i)].data,
                           tpsi[tpsi.site_tag(i)].data)
    assert not torch.equal(out[out.site_tag(2)].data,
                           tpsi[tpsi.site_tag(2)].data)


def test_reset_keeps_the_constant_tags(heis):
    """quimb_tpu's ``reset`` rebuilds the parameters without the
    constructor's tags (``optimize.py:445-450``), so after it a constant
    tensor is optimised; the port keeps them."""
    jpsi, jl, tpsi, tl = pair(heis, seed=19)
    const = [tpsi.site_tag(0)]
    ot = ttn.TNOptimizer(tpsi, tl, constant_tags=const, progbar=False)
    oj = jtn.TNOptimizer(jpsi, jl, constant_tags=const, progbar=False)
    d0 = ot.d
    ot.optimize(2)
    ot.reset()
    oj.reset()
    assert ot.d == d0 and ot.losses == [] and ot.nevals == 0
    assert oj.d > d0  # quimb_tpu's fault: the constant tensor is free again
    out = ot.optimize(2)
    assert torch.equal(out[out.site_tag(0)].data,
                       tpsi[tpsi.site_tag(0)].data)


def test_multi_loss_handler_with_executor(heis):
    """Loss terms fanned out to a thread pool sum to the same value and
    gradient as one term, on other threads."""
    _, _, tpsi, tl = pair(heis, seed=23)
    seen = set()

    def half(psi):
        seen.add(threading.get_ident())
        return tl(psi) / 2

    with ThreadPoolExecutor(2) as ex:
        om = ttn.TNOptimizer(tpsi, [half, half], executor=ex,
                             progbar=False)
        om._vectorizer = ttn.Vectorizer(om.params)
        x = om._vectorizer.pack(om.params)
        vm, gm = om.vectorized_value_and_grad(x)
    o1 = ttn.TNOptimizer(tpsi, tl, progbar=False)
    o1._vectorizer = ttn.Vectorizer(o1.params)
    v1, g1 = o1.vectorized_value_and_grad(x)
    assert abs(vm - v1) <= 1e-14 * abs(v1)
    assert np.linalg.norm(gm - g1) <= 1e-13 * np.linalg.norm(g1)
    assert threading.get_ident() not in seen
    h = ttn.MultiLossHandler([half, half])
    assert abs(float(h(tpsi)) - float(tl(tpsi))) <= 1e-14


def test_get_tn_opt_norm_fn_and_the_other_drivers(heis):
    _, _, tpsi, tl = pair(heis, seed=29)
    def halve(psi):
        psi.apply_to_arrays(lambda x: x / 2)
        return psi

    ot = ttn.TNOptimizer(tpsi, tl, norm_fn=halve,
                         optimizer="sgd", learning_rate=0.01, progbar=False)
    out = ot.optimize(2, tol=1e-30)
    ref = ot.build_fn(ot.params)
    for i in range(L):
        assert torch.allclose(out[out.site_tag(i)].data * 2,
                              ref[ref.site_tag(i)].data)
    # the loss plot (matplotlib's Agg backend): the loss history, labelled
    import matplotlib
    import matplotlib.pyplot as plt

    matplotlib.use("Agg")
    fig, ax = ot.plot(hlines=(0.5,))
    assert list(ax.lines[0].get_ydata()) == list(ot.losses)
    assert ax.get_xlabel() == "iteration" and ax.get_ylabel() == "loss"
    assert list(ax.lines[1].get_ydata()) == [0.5, 0.5]
    plt.close(fig)
    for name in ("optimize_ipopt", "optimize_nlopt", "optimize_nevergrad"):
        with pytest.raises((ImportError, NotImplementedError)):
            getattr(ot, name)(2)
    with pytest.raises(TypeError):
        topt._Rule("adam", 0.1, bogus=1)


def test_vectorizer_round_trip():
    rng = np.random.default_rng(31)
    tree = {"b": torch.as_tensor(rng.standard_normal((2, 3))),
            "a": torch.as_tensor(rng.standard_normal(4)
                                 + 1j * rng.standard_normal(4))}
    v = ttn.Vectorizer(tree)
    x = v.pack(tree)
    assert x.dtype == np.float64 and x.size == v.d == 14
    # the leaves in JAX's order (sorted keys), complex as real then imag
    np.testing.assert_array_equal(x[:4], tree["a"].real.numpy())
    np.testing.assert_array_equal(x[4:8], tree["a"].imag.numpy())
    back = v.unpack(x)
    assert all(torch.equal(back[k], tree[k]) for k in tree)
    jv = jtn.Vectorizer({k: jnp.asarray(t.numpy()) for k, t in tree.items()})
    np.testing.assert_array_equal(
        jv.pack({k: jnp.asarray(t.numpy()) for k, t in tree.items()}), x)
