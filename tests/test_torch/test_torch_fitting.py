"""quimb_torch's ``tensor/fitting.py`` and the methods wired to it
(``Tensor.distance``, ``TensorNetwork.fit`` / ``fit_`` / ``distance`` /
``distance_normalized``, the ``local-fit`` compress mode) against
quimb_tpu's, on the CPU in float64 and complex128, from the same arrays.

Tolerances: 1e-12 relative on distances (three exact contractions);
fitted distances 1e-10 absolute (a few sweeps of small solves, each
conditioned by its normal matrix; the distances here are 1e-3 to 1);
``conjugate_gradient`` 1e-12 relative (the same recurrence)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quimb_torch.tensor as ttn
import quimb_tpu.tensor as jtn
from quimb_torch import convert
from quimb_torch.tensor import fitting as tfit
from quimb_tpu.tensor import fitting as jfit

L = 6


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(chi, seed, dtype="float64"):
    """One random MPS (numpy draws of default_rng(seed)) in both
    packages, normalised."""
    rng = np.random.default_rng(seed)
    arrays = []
    for i in range(L):
        chil, chir = min(chi, 2**i, 2**(L - i)), min(chi, 2**(i + 1),
                                                     2**(L - i - 1))
        shape = ([chil] if i else []) + ([chir] if i < L - 1 else []) + [2]
        x = rng.standard_normal(shape)
        if dtype == "complex128":
            x = x + 1j * rng.standard_normal(shape)
        arrays.append(x)
    j = jtn.MatrixProductState([jnp.asarray(a) for a in arrays],
                               shape="lrp")
    nrm = float(abs(j.H @ j)) ** (0.5 / L)
    j = jtn.MatrixProductState([jnp.asarray(a / nrm) for a in arrays],
                               shape="lrp")
    return j, convert.from_tpu_mps(j, device="cpu")


@pytest.fixture(scope="module")
def states():
    return {dtype: (_pair(3, 1, dtype), _pair(6, 2, dtype))
            for dtype in ("float64", "complex128")}


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_distances_match(states, dtype):
    (ja, ta), (jb, tb) = states[dtype]
    for name in ("distance", "distance_normalized"):
        want = getattr(ja, name)(jb)
        got = getattr(ta, name)(tb)
        assert isinstance(got, float)
        assert abs(got - want) <= 1e-12 * want
    jt, tt = ja[ja.site_tag(2)], ta[ta.site_tag(2)]
    want = jt.distance(jtn.Tensor(jt.data**2, inds=jt.inds))
    got = tt.distance(ttn.Tensor(tt.data**2, inds=tt.inds))
    assert abs(got - want) <= 1e-12 * want
    with pytest.raises(ValueError, match="matching outer"):
        ta.distance(tb.reindex({"k0": "other"}))


@pytest.fixture(scope="module")
def als_fits(states):
    out = {}
    for dtype in ("float64", "complex128"):
        (ja, ta), (jb, tb) = states[dtype]
        for solver in ("solve", "cg", "lstsq", "eigh"):
            fj = ja.fit(jb, method="als", solver=solver, steps=3)
            ft = ta.fit(tb, method="als", solver=solver, steps=3)
            out[dtype, solver] = (fj.distance(jb), ft.distance(tb), ft)
        for method in ("tree", "autodiff"):
            kw = {"steps": 5} if method == "autodiff" else {"steps": 3}
            fj = ja.fit(jb, method=method, **kw)
            ft = ta.fit(tb, method=method, **kw)
            out[dtype, method] = (fj.distance(jb), ft.distance(tb), ft)
    return out


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
@pytest.mark.parametrize("how", ["solve", "cg", "lstsq", "eigh", "tree",
                                 "autodiff"])
def test_fit_matches(als_fits, states, how, dtype):
    dj, dt, ft = als_fits[dtype, how]
    assert abs(dj - dt) <= 1e-10
    (_, ta), (_, tb) = states[dtype]
    if how != "autodiff":
        assert dt < ta.distance(tb)
    assert ft.max_bond() == ta.max_bond()


def test_fit_in_place_and_tags(states):
    (ja, ta), (jb, tb) = states["float64"]
    tags = [ta.site_tag(i) for i in (1, 2)]
    fj = ja.copy().fit_(jb, steps=2, tags=tags)
    ft = ta.copy()
    assert ft.fit_(tb, steps=2, tags=tags) is ft
    assert abs(fj.distance(jb) - ft.distance(tb)) <= 1e-10
    assert torch.equal(ft[ft.site_tag(0)].data, ta[ta.site_tag(0)].data)
    fa = ta.copy()
    tfit.tensor_network_fit_autodiff(fa, tb, steps=3, inplace=True,
                                     progbar=False)
    assert fa.distance(tb) < ta.distance(tb)


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_conjugate_gradient_matches(dtype):
    rng = np.random.default_rng(7)
    n, k = 12, 3
    X = rng.standard_normal((n, n)) + (1j * rng.standard_normal((n, n))
                                       if dtype == "complex128" else 0)
    A = X @ X.conj().T + n * np.eye(n)
    b = rng.standard_normal((n, k)) + (1j * rng.standard_normal((n, k))
                                       if dtype == "complex128" else 0)
    for maxiter, tol in ((3, 1e-5), (40, 1e-5), (40, 1e-30)):
        want = np.asarray(jfit.conjugate_gradient(
            jnp.asarray(A), jnp.asarray(b), tol=tol, maxiter=maxiter))
        got = tfit.conjugate_gradient(torch.as_tensor(A), torch.as_tensor(b),
                                      tol=tol, maxiter=maxiter).numpy()
        assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want)
    x = np.linalg.solve(A, b)
    assert np.linalg.norm(got - x) <= 1e-10 * np.linalg.norm(x)


def _grid(pkg, seed):
    """A 2 x 3 grid network (a loop) from numpy arrays, fixed tids."""
    rng = np.random.default_rng(seed)
    tn = pkg.TensorNetwork([])
    D = 3
    for x in range(2):
        for y in range(3):
            inds, shape = [f"p{x}{y}"], [2]
            for (a, b) in (((x, y), (x + 1, y)), ((x, y), (x, y + 1)),
                           ((x - 1, y), (x, y)), ((x, y - 1), (x, y))):
                if all(0 <= c[0] < 2 and 0 <= c[1] < 3 for c in (a, b)):
                    inds.append(f"b{a}{b}")
                    shape.append(D)
            data = rng.standard_normal(shape)
            data = data if pkg is jtn else torch.as_tensor(data)
            tn.add_tensor(pkg.Tensor(data, inds=tuple(inds),
                                     tags={f"X{x}Y{y}"}), tid=3 * x + y)
    return tn


@pytest.mark.parametrize("mode", ["local-fit", "full-bond"])
def test_compress_between_fit_modes_match(mode):
    """``local-fit`` (ALS on the patch around the bond) and ``full-bond``
    with ``fit=True`` (projectors fitted to the bond environment), both
    deferred until this slice, give quimb_tpu's tensors (1e-9)."""
    j, t = _grid(jtn, 3), _grid(ttn, 3)
    opts = dict(max_bond=2, cutoff=0.0, mode=mode)
    if mode == "local-fit":
        opts.update(steps=3)
    j.compress_between("X0Y1", "X1Y1", **opts)
    t.compress_between("X0Y1", "X1Y1", **opts)
    assert t["X0Y1"].ind_size("b(0, 1)(1, 1)") == 2
    want = np.asarray(j.contract(..., output_inds=sorted(j.outer_inds()))
                      .data)
    got = t.contract(..., output_inds=sorted(t.outer_inds())).data.numpy()
    assert np.linalg.norm(got - want) <= 1e-9 * np.linalg.norm(want)
