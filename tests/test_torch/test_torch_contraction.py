"""quimb_torch's contraction layer (``ops/contraction.py``, ``ops/paths.py``,
``ops/native.py``) against quimb_tpu's, on the CPU.

The same numpy arrays, from ``np.random.default_rng(seed)``, go through
both packages in float64 and complex128. Tolerance: 1e-12 relative for a
contraction, whose result both packages sum in float64 in the same
pairwise order; the paths themselves must be equal.
"""

import numpy as np
import pytest
import torch

from quimb_tpu.ops import contraction as jctr
from quimb_tpu.ops import native as jnative
from quimb_tpu.ops import paths as jpaths
from quimb_torch.ops import contraction as tctr
from quimb_torch.ops import native as tnative
from quimb_torch.ops import paths as tpaths

# float64 sums of a few hundred products in one pairwise order: round-off
RTOL = 1e-12
DTYPES = [np.float64, np.complex128]


def _rand(rng, shape, dtype):
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def rand_case(seed, n_tensors=6, n_inds=8, dtype=np.float64):
    """A random network, as quimb_tpu's ``test_contraction.rand_case``."""
    rng = np.random.default_rng(seed)
    names = [f"i{k}" for k in range(n_inds)]
    sizes = {ix: int(rng.integers(2, 5)) for ix in names}
    inputs = []
    for _ in range(n_tensors):
        k = rng.integers(1, 4)
        inputs.append(tuple(rng.choice(names, size=k, replace=False)))
    for ix in names:
        if not any(ix in t for t in inputs):
            inputs[rng.integers(0, n_tensors)] += (ix,)
    arrays = [_rand(rng, [sizes[ix] for ix in t], dtype) for t in inputs]
    return inputs, sizes, arrays


def _both(arrays, inputs, output, **kwargs):
    """(port, quimb_tpu) results of one contraction, as numpy."""
    t = tctr.array_contract([torch.as_tensor(a) for a in arrays], inputs,
                            output, **kwargs)
    j = jctr.array_contract(arrays, inputs, output, **kwargs)
    assert isinstance(t, torch.Tensor)
    return t.numpy(), np.asarray(j)


def _assert_close(t, j, rtol=RTOL):
    assert t.shape == j.shape
    assert np.linalg.norm(t - j) <= rtol * max(np.linalg.norm(j), 1e-300)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("optimize", ["greedy", "optimal", "random-greedy"])
def test_random_networks_match_quimb_tpu(seed, optimize, dtype):
    inputs, _, arrays = rand_case(seed, dtype=dtype)
    output = tctr.find_output_inds(inputs)
    assert output == jctr.find_output_inds(inputs)
    _assert_close(*_both(arrays, inputs, output, optimize=optimize))


def _special_cases():
    """quimb_tpu's named cases of ``test_contraction.py``: (arrays,
    inputs, output)."""
    rng = np.random.default_rng(0)
    r = rng.standard_normal
    xs = [r((3, 3)) for _ in range(5)]
    return {
        "explicit_output_order": ([r((3, 4)), r((4, 5))],
                                  [("i", "j"), ("j", "k")], ("k", "i")),
        "hyper_index": ([r((3, 4)), r((4, 5)), r((4,))],
                        [("i", "j"), ("j", "k"), ("j",)], ("i", "k")),
        "hyper_output_index": ([r((3, 4)), r((4, 5))],
                               [("i", "j"), ("j", "k")], ("i", "j", "k")),
        "repeated_index": ([r((4, 4, 3)), r((3, 2))],
                           [("i", "i", "j"), ("j", "k")], ("i", "k")),
        "trace_to_scalar": ([r((5, 5))], [("i", "i")], ()),
        "disconnected_outer": ([r((2, 3)), r((4,))],
                               [("i", "j"), ("k",)], ("i", "j", "k")),
        "scalar_chain": (xs, [("a", "b"), ("b", "c"), ("c", "d"),
                              ("d", "e"), ("e", "a")], ()),
        "single_transpose_sum": ([r((2, 3, 4))], [("a", "b", "c")],
                                 ("c", "a")),
    }


@pytest.mark.parametrize("case", sorted(_special_cases()))
def test_special_cases_match_quimb_tpu(case):
    arrays, inputs, output = _special_cases()[case]
    _assert_close(*_both(arrays, inputs, output))


def _ring(n, seed, dtype=np.float64):
    """A ring of ``n`` tensors (2, 2, 2) with one open index each: 2n
    indices in all."""
    rng = np.random.default_rng(seed)
    inputs = [(f"b{i}", f"o{i}", f"b{(i + 1) % n}") for i in range(n)]
    arrays = [_rand(rng, (2, 2, 2), dtype) for _ in range(n)]
    return inputs, arrays


@pytest.mark.parametrize("dtype", DTYPES)
def test_sixty_index_network_contracts(dtype):
    """torch's sublist einsum takes labels only in [0, 52); the port
    relabels each pairwise step from 0. A ring of 30 tensors has 60
    indices; closing its open indices with 30 vectors makes a scalar."""
    inputs, arrays = _ring(30, seed=1, dtype=dtype)
    rng = np.random.default_rng(2)
    inputs += [(f"o{i}",) for i in range(30)]
    arrays += [_rand(rng, (2,), dtype) for _ in range(30)]
    assert len({ix for t in inputs for ix in t}) == 60
    with pytest.raises((ValueError, RuntimeError), match="52"):
        torch.einsum(torch.ones(2, dtype=torch.float64), [60],
                     torch.ones(2, dtype=torch.float64), [60], [])
    _assert_close(*_both(arrays, inputs, (), optimize="greedy"))


@pytest.mark.parametrize("dtype", DTYPES)
def test_pair_step_beyond_52_labels_matches(dtype):
    """One pairwise step of 58 distinct labels goes through permute,
    reshape and matmul: batch, contracted, kept and summed-out labels.
    Most labels have size 1, so the arrays stay small."""
    rng = np.random.default_rng(3)
    size = {ix: 1 for ix in range(58)}
    size.update({0: 2, 12: 3, 22: 2, 31: 3, 51: 2, 53: 2, 50: 3})
    la = list(range(0, 30)) + list(range(52, 58))  # 52-57 summed out of a
    lb = list(range(10, 40)) + [50, 51]            # 50 summed out of b
    # labels 10-19 contract, 20-29 are batch; the output keeps 0-9,
    # 20-29, 30-39 and 51
    lo = [*range(20, 30), *range(0, 10), 51, *range(30, 40)]
    a = _rand(rng, [size[ix] for ix in la], dtype)
    b = _rand(rng, [size[ix] for ix in lb], dtype)
    got = tctr._pair_contract(torch.as_tensor(a), la, torch.as_tensor(b),
                              lb, lo).numpy()
    # numpy's einsum takes 52 labels too: contract the squeezed arrays
    ref = np.einsum(a.sum(axis=tuple(range(30, 36))).reshape(2, 3, 2),
                    [0, 12, 22], b.sum(axis=30).reshape(3, 2, 3, 2),
                    [12, 22, 31, 51], [22, 0, 51, 31])
    _assert_close(got.reshape(ref.shape), ref)


@pytest.mark.parametrize("seed", range(4))
def test_paths_equal_in_both_copies(seed):
    inputs, sizes, _ = rand_case(seed, n_tensors=9, n_inds=12)
    output = tctr.find_output_inds(inputs)
    for name in ("path_greedy", "path_optimal"):
        tp = getattr(tpaths, name)(inputs, output, sizes)
        jp = getattr(jpaths, name)(inputs, output, sizes)
        assert [tuple(s) for s in tp] == [tuple(s) for s in jp]
        assert tpaths.path_cost(inputs, output, sizes, tp) == \
            jpaths.path_cost(inputs, output, sizes, jp)


def north_star_energy_network(L=128, chi=256):
    """The index structure of <psi|H|psi> for the L=128, chi=256 MPS with
    the Heisenberg MPO (bond 5), bonds ``min(2^min(i, L-i), chi)`` as
    DMRG2 at cutoff 0 leaves them: 384 tensors, 643 indices (sizes
    only, no arrays)."""
    def bond(i):
        return min(2 ** min(i, L - i), chi)

    inputs, sizes = [], {}
    for i in range(L):
        inputs.append((f"k{i}", f"p{i}", f"k{i + 1}"))
        inputs.append((f"b{i}", f"q{i}", f"b{i + 1}"))
        inputs.append((f"h{i}", f"h{i + 1}", f"q{i}", f"p{i}"))
        sizes[f"p{i}"] = sizes[f"q{i}"] = 2
    for i in range(L + 1):
        sizes[f"k{i}"] = sizes[f"b{i}"] = bond(i)
        sizes[f"h{i}"] = 1 if i in (0, L) else 5
    return inputs, tctr.find_output_inds(inputs), sizes


def test_north_star_greedy_path_equal_in_both_copies():
    inputs, output, sizes = north_star_energy_network()
    assert len(inputs) == 384 and len(sizes) == 643
    tp = tpaths.path_greedy(inputs, output, sizes)
    jp = jpaths.path_greedy(inputs, output, sizes)
    assert [tuple(s) for s in tp] == [tuple(s) for s in jp]
    flops = tpaths.path_cost(inputs, output, sizes, tp)
    width = tpaths.path_width(inputs, output, sizes, tp)
    assert flops == pytest.approx(2.062e13, rel=1e-3)
    assert width == pytest.approx(30.32, abs=1e-2)


def test_north_star_optimal_path_equal_on_a_window():
    """``path_optimal`` (exact DP over subsets) on the first three sites
    of the same structure: 9 tensors."""
    inputs, _, sizes = north_star_energy_network()
    inputs = inputs[:9]
    output = tctr.find_output_inds(inputs)
    tp = tpaths.path_optimal(inputs, output, sizes)
    jp = jpaths.path_optimal(inputs, output, sizes)
    assert [tuple(s) for s in tp] == [tuple(s) for s in jp]


needs_native = pytest.mark.skipif(
    not (tnative.native_available() and jnative.native_available()),
    reason="native pathfinder not built (no g++)")


@needs_native
@pytest.mark.parametrize("seed", [0, 7])
def test_native_random_greedy_same_path_given_one_seed(seed):
    """With one seed, a fixed repeat count and no wall-clock budget the
    two native searches return the same path."""
    inputs, output, sizes = north_star_energy_network(L=32, chi=16)
    kw = dict(repeats=16, seed=seed, patience=0, max_seconds=0.0,
              stop_flops=0.0)
    tp = tnative.path_rgreedy_native(inputs, output, sizes, **kw)
    jp = jnative.path_rgreedy_native(inputs, output, sizes, **kw)
    assert tp is not None and tp == jp
    assert tp == tnative.path_rgreedy_native(inputs, output, sizes, **kw)


@needs_native
def test_auto_paths_compare_by_cost():
    """``auto`` stops on a wall-clock budget, so only costs compare: both
    copies reach no worse than greedy."""
    inputs, output, sizes = north_star_energy_network(L=32, chi=16)
    greedy = tpaths.path_cost(inputs, output, sizes,
                              tpaths.path_greedy(inputs, output, sizes))
    for P in (tpaths, jpaths):
        p = P.optimize_path(inputs, output, sizes, "auto")
        assert P.path_cost(inputs, output, sizes, p) <= greedy


def test_native_builds_into_the_build_directory():
    if not tnative.native_available():
        pytest.skip("no g++")
    lib = tnative.lib_path()
    assert "/_build/pathfinder-" in lib and lib.endswith("libpathfinder.so")
    assert not lib.startswith(tnative._HERE)


def _check_valid_ssa(path, n):
    avail = set(range(n))
    nxt = n
    for a, b in path:
        assert a in avail and b in avail and a != b
        avail -= {a, b}
        avail.add(nxt)
        nxt += 1
    assert len(avail) == 1


@needs_native
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_native_path_valid_and_executable(seed):
    inputs, sizes, arrays = rand_case(seed, n_tensors=10, n_inds=14)
    output = tctr.find_output_inds(inputs)
    path = tnative.path_rgreedy_native(inputs, output, sizes, seed=seed)
    _check_valid_ssa(path, len(inputs))
    _assert_close(*_both(arrays, inputs, output, optimize="random-greedy"))


def test_expression_cache_and_metadata():
    expr = tctr.array_contract_expression(
        [("i", "j"), ("j", "k")], ("i", "k"), shapes=[(8, 8), (8, 8)])
    expr2 = tctr.array_contract_expression(
        [("x", "y"), ("y", "z")], ("x", "z"), shapes=[(8, 8), (8, 8)])
    assert expr is expr2  # canonicalised geometry, one cache entry
    jexpr = jctr.array_contract_expression(
        [("i", "j"), ("j", "k")], ("i", "k"), shapes=[(8, 8), (8, 8)])
    assert (expr.flops, expr.width, expr.path) == \
        (jexpr.flops, jexpr.width, jexpr.path)
    rng = np.random.default_rng(7)
    a, b = rng.standard_normal((8, 8)), rng.standard_normal((8, 8))
    got = expr(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    _assert_close(got, a @ b)


def test_array_contract_path_matches():
    inputs, sizes, arrays = rand_case(5, n_tensors=7)
    output = tctr.find_output_inds(inputs)
    tp = tctr.array_contract_path([torch.as_tensor(a) for a in arrays],
                                  inputs, output, optimize="greedy")
    jp = jctr.array_contract_path(arrays, inputs, output, optimize="greedy")
    assert [tuple(s) for s in tp] == [tuple(s) for s in jp]
    tree = tctr.array_contract_tree(inputs, output, sizes=sizes,
                                    optimize="greedy")
    assert tree.flops == jctr.array_contract_tree(
        inputs, output, sizes=sizes, optimize="greedy").flops


def test_renorm_matches_quimb_tpu():
    inputs, _, arrays = rand_case(6, n_tensors=7)
    output = tctr.find_output_inds(inputs)
    _assert_close(*_both(arrays, inputs, output, renorm=True))


def test_numpy_backend_keeps_host_arrays():
    inputs, _, arrays = rand_case(4)
    output = tctr.find_output_inds(inputs)
    with tctr.contract_backend("numpy"):
        got = tctr.array_contract(arrays, inputs, output)
    assert isinstance(got, np.ndarray)
    _assert_close(got, np.asarray(jctr.array_contract(arrays, inputs,
                                                      output)))
    # numpy operands only: numpy too, without the context
    assert isinstance(tctr.array_contract(arrays, inputs, output),
                      np.ndarray)


def test_mixed_dtypes_promote():
    rng = np.random.default_rng(8)
    a = rng.standard_normal((3, 4))
    b = _rand(rng, (4, 5), np.complex128)
    c = rng.standard_normal((5, 2))
    arrays, inputs = [a, b, c], [("i", "j"), ("j", "k"), ("k", "l")]
    _assert_close(*_both(arrays, inputs, ("i", "l")))


def test_strategy_and_backend_contexts():
    assert tctr.get_contract_strategy() == "auto"
    with tctr.contract_strategy("greedy"):
        assert tctr.get_contract_strategy() == "greedy"
    assert tctr.get_contract_strategy() == "auto"
    assert tctr.get_contract_backend() is None
    with tctr.contract_backend("numpy"):
        assert tctr.get_contract_backend() == "numpy"
    assert tctr.inds_to_eq([("a", "b"), ("b", "c")]) == \
        jctr.inds_to_eq([("a", "b"), ("b", "c")])
