"""Contraction execution: run a path as a chain of pairwise contractions,
with expression caching.

Port of quimb_tpu's ``ops/contraction.py`` to torch. The path comes from
:mod:`.paths`; each pairwise step sums out the labels private to one
operand, then runs as permute, reshape and one batched ``matmul``
(:func:`_pair_contract`), which takes labels of any value. A one-term step
(trace, transpose, sum) runs as ``einsum`` in integer-label (sublist) form
with its labels renumbered from 0, because torch's sublist ``einsum`` takes
labels only in ``[0, 52)`` and a network's expression numbers every index
of the whole network.

Expressions (path + per-step label lists) are cached keyed by the
contraction geometry, with the index names canonicalised, so networks of
one structure share one expression.
"""

import contextlib
import functools
import math
import threading

import numpy as np
import torch

from ..utils import LRU
from . import paths as _paths

#: distinct labels a sublist einsum accepts, in torch and in numpy
MAX_EINSUM_LABELS = 52

# -- thread-local default strategy / backend contexts ------------------------

_DEFAULT_STRATEGY = "auto"
# None: numpy when every operand is a numpy array, else torch
_DEFAULT_BACKEND = None
_thread = threading.local()


def _stack(name, default):
    stacks = getattr(_thread, "stacks", None)
    if stacks is None:
        _thread.stacks = stacks = {}
    return stacks.setdefault(name, [default])


def get_contract_strategy():
    return _stack("strategy", _DEFAULT_STRATEGY)[-1]


def set_contract_strategy(strategy):
    _stack("strategy", _DEFAULT_STRATEGY)[-1] = strategy


@contextlib.contextmanager
def contract_strategy(strategy):
    """Context manager setting the default contraction path strategy."""
    s = _stack("strategy", _DEFAULT_STRATEGY)
    s.append(strategy)
    try:
        yield
    finally:
        s.pop()


def get_contract_backend():
    return _stack("backend", _DEFAULT_BACKEND)[-1]


def set_contract_backend(backend):
    _stack("backend", _DEFAULT_BACKEND)[-1] = backend


@contextlib.contextmanager
def contract_backend(backend):
    """Context manager setting the array backend ('torch' or 'numpy')."""
    s = _stack("backend", _DEFAULT_BACKEND)
    s.append(backend)
    try:
        yield
    finally:
        s.pop()



# quimb_tpu keeps a third stack, the backend of its tensor linear operators,
# which it sets and never reads: it selects nothing there, nor here. Kept so
# code written against quimb_tpu's names runs unchanged.


def get_tensor_linop_backend():
    return _stack("linop_backend", _DEFAULT_BACKEND)[-1]


def set_tensor_linop_backend(backend):
    _stack("linop_backend", _DEFAULT_BACKEND)[-1] = backend


@contextlib.contextmanager
def tensor_linop_backend(backend):
    """Context manager setting the linear operators' backend (selects
    nothing: no code reads it)."""
    s = _stack("linop_backend", _DEFAULT_BACKEND)
    s.append(backend)
    try:
        yield
    finally:
        s.pop()


# -- eq utilities ------------------------------------------------------------


@functools.lru_cache(2**12)
def get_symbol(i):
    """Letter symbol for index ``i`` (a-z, A-Z, then unicode)."""
    if i < 26:
        return chr(ord("a") + i)
    if i < 52:
        return chr(ord("A") + i - 26)
    return chr(192 + i - 52)


def inds_to_eq(inputs, output=None):
    """Turn index tuples into a string einsum equation (for display;
    execution uses integer labels)."""
    symbol_map = {}

    def sym(ix):
        if ix not in symbol_map:
            symbol_map[ix] = get_symbol(len(symbol_map))
        return symbol_map[ix]

    lhs = ",".join("".join(sym(ix) for ix in term) for term in inputs)
    if output is None:
        output = find_output_inds(inputs)
    rhs = "".join(sym(ix) for ix in output)
    return f"{lhs}->{rhs}"


def find_output_inds(inputs):
    """Default output indices: those appearing exactly once over all
    inputs (hyper-aware)."""
    freq = {}
    for term in inputs:
        for ix in term:
            freq[ix] = freq.get(ix, 0) + 1
    return tuple(ix for ix, c in freq.items() if c == 1)


# -- the execution modules: torch, and numpy for host operands ---------------


def _relabel(*terms):
    """The terms with their labels renumbered from 0 in order of first
    appearance, and the number of distinct labels."""
    label = {}
    out = [[label.setdefault(ix, len(label)) for ix in term]
           for term in terms]
    return out, len(label)


def _is_np(x):
    return isinstance(x, np.ndarray)


def _permute(x, perm):
    if list(perm) == list(range(len(perm))):
        return x
    return np.transpose(x, perm) if _is_np(x) else x.permute(*perm)


def _sum_private(x, lx, keep):
    """Sum out the axes of ``x`` whose labels are not in ``keep``."""
    axes = tuple(i for i, ix in enumerate(lx) if ix not in keep)
    if not axes:
        return x, list(lx)
    x = np.sum(x, axis=axes) if _is_np(x) else torch.sum(x, dim=axes)
    return x, [ix for ix in lx if ix in keep]


def _pair_contract(a, la, b, lb, lo):
    """One pairwise step, ``einsum(a, la, b, lb, lo)``, through permute,
    reshape and one batched matmul, for labels of any value and number.
    No label repeats within ``la``, ``lb`` or ``lo``."""
    so = set(lo)
    a, la = _sum_private(a, la, so.union(lb))
    b, lb = _sum_private(b, lb, so.union(la))
    pa = {ix: i for i, ix in enumerate(la)}
    pb = {ix: i for i, ix in enumerate(lb)}
    batch = [ix for ix in lo if ix in pa and ix in pb]
    keep_a = [ix for ix in la if ix not in pb]
    keep_b = [ix for ix in lb if ix not in pa]
    con = [ix for ix in la if ix in pb and ix not in so]
    da = [a.shape[pa[ix]] for ix in batch]
    ka = [a.shape[pa[ix]] for ix in keep_a]
    kb = [b.shape[pb[ix]] for ix in keep_b]
    nb, nc = math.prod(da), math.prod(a.shape[pa[ix]] for ix in con)
    A = _permute(a, [pa[ix] for ix in (*batch, *keep_a, *con)])
    B = _permute(b, [pb[ix] for ix in (*batch, *con, *keep_b)])
    A = A.reshape(nb, math.prod(ka), nc)
    B = B.reshape(nb, nc, math.prod(kb))
    if not _is_np(A) and A.dtype != B.dtype:
        dt = torch.promote_types(A.dtype, B.dtype)
        A, B = A.to(dt), B.to(dt)
    C = (A @ B).reshape((*da, *ka, *kb))
    pc = {ix: i for i, ix in enumerate((*batch, *keep_a, *keep_b))}
    return _permute(C, [pc[ix] for ix in lo])


def _single_contract(a, la, lo):
    """One-term step (trace, transpose, sum): ``einsum(a, la, lo)`` with
    the labels renumbered from 0; beyond :data:`MAX_EINSUM_LABELS` a sum
    and a permute (the term has no repeated label there, as
    :func:`_preprocess_single` leaves it)."""
    (la, lo), n = _relabel(la, lo)
    if n > MAX_EINSUM_LABELS:
        a, la = _sum_private(a, la, set(lo))
        return _permute(a, [la.index(ix) for ix in lo])
    if _is_np(a):
        return np.asarray(np.einsum(a, la, lo, optimize=True))
    return torch.einsum(a, la, lo)


def _renorm(r):
    """``r`` over its largest magnitude, when that is finite and nonzero."""
    if _is_np(r):
        mx = np.max(np.abs(r)) if r.size else 1.0
        return r / mx if (mx > 0 and np.isfinite(mx)) else r
    mx = torch.max(torch.abs(r))
    return torch.where((mx > 0) & torch.isfinite(mx), r / mx, r)


def _use_numpy(arrays, backend=None):
    """Whether a chain runs in numpy: when asked for, or when *every*
    operand is already a host array (setup-time graph rewrites stay off
    the device). Otherwise it runs in torch."""
    if backend is None:
        backend = get_contract_backend()
    if backend == "numpy":
        return True
    if backend == "torch":
        return False
    return bool(arrays) and all(_is_np(a) for a in arrays)


def _to_backend(arrays, use_numpy):
    """The operands as numpy arrays, or as torch tensors on one device:
    that of the first torch operand, else the default device."""
    from .backend import resolve_device, to_device, to_host

    if use_numpy:
        return [to_host(a) for a in arrays]
    device = next((a.device for a in arrays if isinstance(a, torch.Tensor)),
                  None)
    device = resolve_device(device)
    return [a if (isinstance(a, torch.Tensor) and a.device == device)
            else to_device(a, device=device) for a in arrays]


# -- expression building -----------------------------------------------------


class ContractExpression:
    """A compiled contraction: path + per-step integer labels.

    Calling it with matching arrays executes the pairwise chain, freeing
    each intermediate once the step that consumes it has run. The
    instance also carries cost/width metadata for introspection.
    """

    __slots__ = ("inputs", "output", "sizes", "path", "steps", "flops",
                 "width", "_final_perm")

    def __init__(self, inputs, output, sizes, path):
        self.inputs = inputs
        self.output = output
        self.sizes = sizes
        self.path = path
        steps = []
        rout = None
        for (ia, ib, rout), step in zip(
            _paths.simulate_path(inputs, output, sizes, path), path
        ):
            steps.append((step, tuple(ia),
                          None if ib is None else tuple(ib), tuple(rout)))
        self.steps = steps
        # the last result's axes, permuted to the requested output order
        self._final_perm = None
        if rout is not None and tuple(rout) != tuple(output):
            self._final_perm = [tuple(rout).index(ix) for ix in output]
        self.flops = _paths.path_cost(inputs, output, sizes, path)
        self.width = _paths.path_width(inputs, output, sizes, path)

    def __call__(self, *arrays, backend=None, renorm=False):
        """Execute. With ``renorm`` every intermediate is rescaled to
        unit max-magnitude (the scale is not tracked: callers use it for
        scale-free quantities)."""
        results = _to_backend(arrays, _use_numpy(arrays, backend))
        for step, la, lb, lo in self.steps:
            if lb is None:
                (i,) = step
                r = _single_contract(results[i], la, lo)
                results[i] = None
            else:
                i, j = step
                r = _pair_contract(results[i], la, results[j], lb, lo)
                results[i] = results[j] = None
            if renorm:
                r = _renorm(r)
            results.append(r)
        r = results[-1]
        if self._final_perm is not None:
            r = _permute(r, self._final_perm)
        return r

    def __repr__(self):
        return (
            f"<ContractExpression(n={len(self.inputs)}, "
            f"flops={self.flops:.3e}, width={self.width:.1f})>"
        )


_EXPR_CACHE = LRU(2**12)
# a read of the LRU reorders it: threads that contract at once (a local
# expectation's terms under an executor) take turns with the cache
_EXPR_LOCK = threading.Lock()


def _preprocess_single(array, term):
    """Collapse repeated indices within one tensor to their diagonal."""
    if len(set(term)) == len(term):
        return array, tuple(term)
    out_term = tuple(dict.fromkeys(term))
    return _single_contract(array, term, out_term), out_term


def array_contract_expression(
    inputs, output=None, sizes=None, shapes=None, optimize=None, cache=True,
):
    """Build (or fetch from cache) a :class:`ContractExpression`.

    Index labels are canonicalized (first-occurrence integer ids) before
    both caching and path search, so structurally identical contractions
    share one cached path/expression even when their index names differ.
    Execution is purely positional, so callers are unaffected.
    """
    inputs = tuple(map(tuple, inputs))
    if output is None:
        output = find_output_inds(inputs)
    output = tuple(output)
    if sizes is None:
        sizes = {}
        for term, shape in zip(inputs, shapes):
            for ix, d in zip(term, shape):
                sizes[ix] = int(d)
    if optimize is None:
        optimize = get_contract_strategy()

    remap = {}
    c_inputs = tuple(
        tuple(remap.setdefault(ix, len(remap)) for ix in term)
        for term in inputs
    )
    c_output = tuple(remap.setdefault(ix, len(remap)) for ix in output)
    c_sizes = {k: int(sizes[ix]) for ix, k in remap.items()}

    hashable_opt = optimize if isinstance(optimize, str) else str(optimize)
    key = (
        c_inputs, c_output,
        tuple(c_sizes[k] for k in range(len(remap))), hashable_opt,
    )
    if cache:
        with _EXPR_LOCK:
            expr = _EXPR_CACHE.get(key)
        if expr is not None:
            return expr
    path = _paths.optimize_path(c_inputs, c_output, c_sizes, optimize)
    expr = ContractExpression(c_inputs, c_output, c_sizes, path)
    if cache:
        with _EXPR_LOCK:
            _EXPR_CACHE[key] = expr
    return expr


def array_contract(
    arrays, inputs, output=None, optimize=None, backend=None,
    return_expression=False, renorm=False,
):
    """Contract ``arrays`` whose indices are given by ``inputs``."""
    arrays = list(arrays)
    inputs = list(map(tuple, inputs))
    arrays = _to_backend(arrays, _use_numpy(arrays, backend))
    for i, (a, term) in enumerate(zip(arrays, inputs)):
        arrays[i], inputs[i] = _preprocess_single(a, term)

    if output is None:
        output = find_output_inds(inputs)
    output = tuple(output)

    if len(arrays) == 1:
        return _single_contract(arrays[0], inputs[0], output)

    if len(arrays) == 2 and not renorm and not return_expression:
        # one pairwise step: no expression, no cache round trip
        return _pair_contract(arrays[0], inputs[0], arrays[1], inputs[1],
                              output)

    shapes = [a.shape for a in arrays]
    expr = array_contract_expression(
        inputs, output, shapes=shapes, optimize=optimize
    )
    result = expr(*arrays, backend=backend, renorm=renorm)
    if return_expression:
        return result, expr
    return result


def array_contract_path(arrays=None, inputs=None, output=None, sizes=None,
                        shapes=None, optimize=None):
    """Just the (linear) contraction path."""
    inputs = tuple(map(tuple, inputs))
    if shapes is None and arrays is not None:
        shapes = [tuple(a.shape) for a in arrays]
    expr = array_contract_expression(
        inputs, output, sizes=sizes, shapes=shapes, optimize=optimize
    )
    return _paths.ssa_to_linear(expr.path, len(inputs))


def array_contract_tree(inputs, output=None, sizes=None, shapes=None,
                        optimize=None):
    """The ContractExpression (it stands in for cotengra's tree and
    exposes .path/.flops/.width)."""
    return array_contract_expression(
        inputs, output, sizes=sizes, shapes=shapes, optimize=optimize
    )
