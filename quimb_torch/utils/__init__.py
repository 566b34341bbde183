"""Small utilities of the tensor-network layer: option checks, the
insertion-ordered set that holds indices and tags, an LRU cache dict, and
a few iteration helpers. A copy of the parts of quimb_tpu's ``utils`` that
the layer uses, with the tree helpers, rolling statistics, disk
persistence, number formatting and the plotting style decorator; plain
Python, nothing of torch."""

import collections
import collections.abc
import functools
import itertools
import math
import pickle
import time

def check_opt(name, value, valid):
    """Check whether ``value`` takes one of ``valid`` options, raise
    informatively if not."""
    if value not in valid:
        raise ValueError(
            f"'{name}' should be one of {valid} but got '{value}' instead."
        )


# --------------------------------------------------------------------------
# ordered set — the core index/tag container
# --------------------------------------------------------------------------


def _as_keyview(obj):
    """View any iterable / oset as something supporting fast ``in`` and
    iteration — osets expose their backing dict, other iterables are
    materialized into one."""
    backing = getattr(obj, "_d", None)
    return backing if backing is not None else dict.fromkeys(obj)


class oset(collections.abc.MutableSet):
    """Insertion-ordered set used as the core index/tag container.

    Fills the role of reference ``quimb/utils.py:351`` but is built as a
    ``collections.abc.MutableSet``: the ABC supplies the full comparison
    / algebra protocol from three primitives, while the bulk set
    operations below are written as single dict-comprehension merges for
    speed (they are on the TN bookkeeping hot path).
    """

    __slots__ = ("_d",)

    def __init__(self, it=()):
        self._d = dict.fromkeys(it)

    # -- the three MutableSet primitives + constructor hook --

    def __contains__(self, x):
        return x in self._d

    def __iter__(self):
        yield from self._d

    def __len__(self):
        return len(self._d)

    def add(self, k):
        self._d[k] = None

    def discard(self, k):
        self._d.pop(k, None)

    @classmethod
    def _from_iterable(cls, it):
        return cls(it)

    # -- construction / copying --

    @classmethod
    def _from_dict(cls, d):
        self = cls.__new__(cls)
        self._d = d
        return self

    @classmethod
    def from_dict(cls, d):
        return cls._from_dict(d.copy())

    def copy(self):
        return type(self)._from_dict(dict(self._d))

    __copy__ = copy

    def __deepcopy__(self, memo):
        memo[id(self)] = new = self.copy()
        return new

    # -- bulk operations: each is one dict-comprehension / merge --

    def remove(self, k):
        del self._d[k]

    def clear(self):
        self._d.clear()

    def update(self, *others):
        d = self._d
        for o in others:
            d.update(_as_keyview(o))

    def union(self, *others):
        new = self.copy()
        new.update(*others)
        return new

    def intersection(self, *others):
        if not others:
            return self.copy()
        views = [_as_keyview(o) for o in others]
        kept = {
            k: None for k in self._d
            if all(k in v for v in views)
        }
        return type(self)._from_dict(kept)

    def intersection_update(self, *others):
        if others:
            self._d = self.intersection(*others)._d

    def difference(self, *others):
        views = [_as_keyview(o) for o in others]
        kept = {
            k: None for k in self._d
            if not any(k in v for v in views)
        }
        return type(self)._from_dict(kept)

    def difference_update(self, *others):
        self._d = self.difference(*others)._d

    def symmetric_difference(self, other):
        return self ^ type(self)(other)

    # -- ordered-container extras --

    def popleft(self):
        it = iter(self._d)
        k = next(it)
        del self._d[k]
        return k

    def popright(self):
        k, _ = self._d.popitem()
        return k

    pop = popright

    # -- fast-path operators (the ABC mixins are element-wise) --

    def __or__(self, other):
        return self.union(other)

    def __and__(self, other):
        return self.intersection(other)

    def __sub__(self, other):
        return self.difference(other)

    def __eq__(self, other):
        if isinstance(other, oset):
            return self._d.keys() == other._d.keys()
        return super().__eq__(other)

    __hash__ = None

    def __repr__(self):
        return f"oset({list(self._d)})"

    def __getstate__(self):
        return tuple(self._d)

    def __setstate__(self, keys):
        self._d = dict.fromkeys(keys)


# --------------------------------------------------------------------------
# LRU cache dict
# --------------------------------------------------------------------------


class LRU(collections.abc.MutableMapping):
    """Size-capped mapping with least-recently-used eviction (role of
    reference quimb/utils.py:489). Recency is tracked by re-inserting
    touched keys at the back of a plain (insertion-ordered) dict; the
    front entry is therefore always the eviction candidate.
    """

    __slots__ = ("_store", "maxsize")

    def __init__(self, maxsize, *args, **kwds):
        self.maxsize = maxsize
        self._store = {}
        self.update(*args, **kwds)

    def __getitem__(self, key):
        # pop + reinsert moves key to the most-recent slot
        self._store[key] = value = self._store.pop(key)
        return value

    def __setitem__(self, key, value):
        store = self._store
        store.pop(key, None)
        store[key] = value
        while len(store) > self.maxsize:
            del store[next(iter(store))]

    def __delitem__(self, key):
        del self._store[key]

    def __iter__(self):
        return iter(self._store)

    def __len__(self):
        return len(self._store)

    def __contains__(self, key):
        return key in self._store

    def copy(self):
        """Independent LRU with the same contents and capacity.
        Important: objects holding LRU caches (e.g. circuits) copy
        attribute-wise — without this the *same* cache would be shared
        between the copies and stale entries would leak across them."""
        new = type(self)(self.maxsize)
        new._store = dict(self._store)
        return new

    __copy__ = copy

    def __repr__(self):
        return f"LRU(maxsize={self.maxsize}, size={len(self._store)})"


def ensure_dict(x):
    """Make sure ``x`` is a dict, creating an empty one if ``x is None``."""
    if x is None:
        return {}
    return dict(x)


def pairwise(iterable):
    """s -> (s0,s1), (s1,s2), (s2,s3), ..."""
    a, b = itertools.tee(iterable)
    next(b, None)
    return zip(a, b)


def unique(it):
    """Yield unique elements of ``it``, preserving order."""
    return iter(dict.fromkeys(it))


def concat(its):
    return itertools.chain.from_iterable(its)


def frequencies(it):
    f = {}
    for k in it:
        f[k] = f.get(k, 0) + 1
    return f


def partition_all(n, it):
    it = iter(it)
    while True:
        chunk = tuple(itertools.islice(it, n))
        if not chunk:
            return
        yield chunk


def valmap(fn, d):
    return {k: fn(v) for k, v in d.items()}


# --------------------------------------------------------------------------
# generic tree mapping (reference utils.py:617-890)
# --------------------------------------------------------------------------


def is_not_container(x):
    """The default ``is_leaf`` definition: anything that isn't a
    tuple/list/dict."""
    return not isinstance(x, (tuple, list, dict))


def tree_map(f, tree, is_leaf=is_not_container):
    """Map ``f`` over all leaves of ``tree``, rebuilding the same nested
    structure of tuples, lists and dicts."""
    if is_leaf(tree):
        return f(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(f, x, is_leaf) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(f, v, is_leaf) for k, v in tree.items()}
    return f(tree)


def tree_apply(f, tree, is_leaf=is_not_container):
    """Apply ``f`` to all leaves of ``tree``, no new tree built."""
    if is_leaf(tree):
        f(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            tree_apply(f, x, is_leaf)
    elif isinstance(tree, dict):
        for v in tree.values():
            tree_apply(f, v, is_leaf)
    else:
        f(tree)


def tree_flatten(tree, is_leaf=is_not_container):
    """Flatten ``tree`` into a list of leaves."""
    out = []
    tree_apply(out.append, tree, is_leaf)
    return out


def tree_unflatten(leaves, tree, is_leaf=is_not_container):
    """Rebuild a tree with the structure of ``tree`` from the flat
    iterator ``leaves``."""
    leaves = iter(leaves)

    def _rebuild(t):
        if is_leaf(t):
            return next(leaves)
        if isinstance(t, (list, tuple)):
            return type(t)(_rebuild(x) for x in t)
        if isinstance(t, dict):
            return {k: _rebuild(v) for k, v in t.items()}
        return next(leaves)

    return _rebuild(tree)


# --------------------------------------------------------------------------
# rolling statistics (reference utils.py:512-570) — used for convergence
# --------------------------------------------------------------------------


class RollingMeanVar:
    """Tracks mean and variance over a rolling window."""

    def __init__(self, window=10):
        self.window = window
        self.xs = []

    def update(self, x):
        self.xs.append(x)
        if len(self.xs) > self.window:
            self.xs.pop(0)

    @property
    def mean(self):
        return sum(self.xs) / len(self.xs)

    @property
    def var(self):
        m = self.mean
        return sum((x - m) ** 2 for x in self.xs) / len(self.xs)

    @property
    def std(self):
        return self.var**0.5


class Timer:
    """Simple context-manager timer."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t = time.perf_counter() - self.t0


def default_to_neutral_style(fn):
    """Decorator for plotting functions — wrap to use a neutral
    matplotlib style (reference quimb/utils_plot.py)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            import matplotlib.pyplot as plt

            with plt.style.context("default"):
                return fn(*args, **kwargs)
        except ImportError:
            return fn(*args, **kwargs)

    return wrapper


# --------------------------------------------------------------------------
# disk persistence (reference utils.py:312-324 used joblib; plain pickle here)
# --------------------------------------------------------------------------


def save_to_disk(obj, fname, **kwargs):
    """Save an object to disk using pickle."""
    with open(fname, "wb") as f:
        pickle.dump(obj, f, **kwargs)


def load_from_disk(fname, **kwargs):
    """Load an object from disk saved with ``save_to_disk``."""
    with open(fname, "rb") as f:
        return pickle.load(f, **kwargs)


# --------------------------------------------------------------------------
# numbers / formatting
# --------------------------------------------------------------------------


def format_number_with_error(x, err):
    """Given ``x`` with error ``err``, format as a string with the
    uncertainty bracketed, e.g. ``1.234(5)``.
    (reference quimb/utils.py:259)."""
    if err <= 0.0 or not math.isfinite(err):
        return f"{x}"
    # number of digits after decimal point to display
    mag_err = math.floor(math.log10(err))
    err_digit = round(err / 10**mag_err)
    if err_digit == 10:
        mag_err += 1
        err_digit = 1
    ndp = max(-mag_err, 0)
    if ndp == 0:
        return f"{round(x):d}({err_digit * 10**mag_err:d})"
    return f"{x:.{ndp}f}({err_digit})"


def deprecated(fn, old_name, new_name):
    """Wrap ``fn`` to warn about deprecation of ``old_name``."""

    @functools.wraps(fn)
    def new_fn(*args, **kwargs):
        import warnings

        warnings.warn(
            f"The {old_name} function is deprecated in favor of {new_name}",
            FutureWarning,
        )
        return fn(*args, **kwargs)

    return new_fn


def int2tup(x):
    return (
        x
        if isinstance(x, tuple)
        else (x,)
        if isinstance(x, int)
        else tuple(x)
    )


# --------------------------------------------------------------------------
# misc parity helpers (reference utils.py:78-960)
# --------------------------------------------------------------------------

def find_library(x):
    """Whether library ``x`` is importable (reference utils.py:78)."""
    from importlib.util import find_spec

    return find_spec(x) is not None


def raise_cant_find_library_function(x, extra_msg=None):
    """A stand-in function that raises on call, flagging the missing
    optional dependency ``x`` only at use time (reference
    utils.py:95)."""

    def function_that_will_raise(*_, **__):
        error_msg = f"The library {x} is not installed. "
        if extra_msg is not None:
            error_msg += extra_msg
        raise ImportError(error_msg)

    return function_that_will_raise


def print_multi_line(*lines, max_width=None):
    """Print multiple lines aligned side by side, wrapping jointly at
    ``max_width`` columns (reference utils.py:219)."""
    if max_width is None:
        import shutil

        max_width, _ = shutil.get_terminal_size()
    max_line_length = max(map(len, lines))
    if max_line_length <= max_width:
        for ln in lines:
            print(ln)
        return
    max_width -= 10  # for ellipses and pad
    n_lines = len(lines)
    n_blocks = (max_line_length - 1) // max_width + 1
    for i in range(n_blocks):
        for j, l in enumerate(lines):
            pre = "..." if i != 0 else "   "
            post = "..." if i != n_blocks - 1 else "   "
            print(pre, l[i * max_width:(i + 1) * max_width], post)
        if i != n_blocks - 1:
            print(("." * 10).center(max_width + 10))


class Verbosify:
    """Wrap a function to print before and after each call (reference
    utils.py:326)."""

    def __init__(self, fn, highlight=None, mpi=False):
        self.fn = fn
        self.highlight = highlight
        self.mpi = mpi

    def __call__(self, *args, **kwargs):
        if self.highlight is None:
            print(f"{self.fn.__name__}(...)")
        else:
            print(
                f"{self.fn.__name__}(..., "
                f"{self.highlight}={kwargs.get(self.highlight)})"
            )
        return self.fn(*args, **kwargs)


class RollingDiffMean:
    """Absolute rolling mean of successive diffs, for convergence
    assessment (role of reference utils.py:512). Keeps the last
    ``size + 1`` finite values in a bounded deque; the windowed mean of
    consecutive diffs telescopes to ``(y[-1] - y[0]) / size`` so no
    running sum needs maintaining.
    """

    def __init__(self, size=16):
        self.size = size
        self._ys = collections.deque(maxlen=size + 1)

    def update(self, y):
        y = float(y)
        if math.isfinite(y):
            self._ys.append(y)

    def absmeandiff(self):
        ys = self._ys
        if len(ys) <= self.size:
            return math.inf
        return abs(ys[-1] - ys[0]) / self.size


class ExponentialGeometricRollingDiffMean:
    """Exponentially-weighted geometric rolling mean of absolute diffs
    (role of reference utils.py:545), maintained in log space: the
    geometric update ``v <- v**(1-f) * dy**f`` is an arithmetic moving
    average of ``log(dy)``.
    """

    def __init__(self, factor=1 / 3, initial=1.0):
        self.factor = factor
        self._logv = math.log(initial)
        self._prev = None  # (y, x) at last update
        self.dy = None

    @property
    def value(self):
        return math.exp(self._logv)

    def update(self, y, x=None):
        if self._prev is not None:
            py, px = self._prev
            dy = abs(y - py)
            if (x is not None) and (px is not None):
                dy /= abs(x - px)
            self.dy = dy
            f = self.factor
            # log(0) -> float-min-exp so a zero diff saturates, not errors
            logdy = math.log(dy) if dy > 0.0 else -745.0
            self._logv = (1.0 - f) * self._logv + f * logdy
        self._prev = (y, x)


def gen_bipartitions(it):
    """All unique bipartitions of ``it`` (reference utils.py:571)."""
    it = list(it)
    n = len(it)
    if n:
        for i in range(1, 2 ** (n - 1)):
            bits = f"{i:0>{n}b}"
            l, r = [], []
            for b, x in zip(bits, it):
                (l if b == "0" else r).append(x)
            yield l, r


def gen_bipartitions_balanced_first(it):
    """All unique bipartitions, most balanced first (reference
    utils.py:585)."""
    import itertools as _it

    first, *rem = it
    m = len(rem)
    sizes = sorted(range(m), key=lambda k: abs((k + 1) - (m - k)))
    for k in sizes:
        for ladd in _it.combinations(rem, k):
            left = (first, *ladd)
            right = tuple(x for x in rem if x not in left)
            yield left, right


def tree_iter(tree, is_leaf=is_not_container):
    """Iterate over all leaves of ``tree`` (reference utils.py:701)."""
    if is_leaf(tree):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from tree_iter(x, is_leaf)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tree_iter(v, is_leaf)
    else:
        yield tree


class _Leaf:
    """Singleton placeholder marking leaf positions in reference trees
    (reference utils.py:770)."""

    __slots__ = ()

    def __repr__(self):
        return "Leaf"


Leaf = _Leaf()


def is_leaf_object(x):
    return x is Leaf


def autocorrect_kwargs(func=None, valid_kwargs=None):
    """Decorator that raises with close-match suggestions on wrong
    keyword arguments (reference utils.py:896)."""
    import functools as _ft

    if func is None:
        return _ft.partial(autocorrect_kwargs,
                           valid_kwargs=valid_kwargs)
    if valid_kwargs is None:
        import inspect

        valid = set(inspect.signature(func).parameters)
    else:
        valid = set(valid_kwargs)

    @_ft.wraps(func)
    def wrapped(*args, **kwargs):
        wrong = {kw for kw in kwargs if kw not in valid}
        if wrong:
            import difflib

            sugg = ", ".join(
                str(difflib.get_close_matches(o, valid, n=3))
                for o in wrong
            )
            raise ValueError(
                f"Option(s) {wrong} not valid.\n Did you mean: "
                f"{sugg}?"
            )
        return func(*args, **kwargs)

    return wrapped


def hash_kwargs_to_int(**kwargs):
    """Deterministic 32-bit hash of keyword arguments (reference
    utils.py:942)."""
    import hashlib

    s = str(sorted(kwargs.items()))
    return int(hashlib.md5(s.encode()).hexdigest(), 16) % (2**32 - 1)


_TREE_CONTAINER_TYPES = []


def tree_register_container(cls, mapper, iterator, applier):
    """Register a custom container type for the tree utilities
    (reference utils.py:617). Registered types are treated as
    containers by ``is_not_container``; the mapper/iterator/applier
    hooks are stored for advanced use."""
    _TREE_CONTAINER_TYPES.append((cls, mapper, iterator, applier))




# --------------------------------------------------------------------------
# progress bars (tqdm where it is installed)
# --------------------------------------------------------------------------

try:
    from tqdm import tqdm as _tqdm

    def progbar(it=None, ascii=True, **kwargs):
        return _tqdm(it, ascii=ascii, **kwargs)

    class continuous_progbar(_tqdm):
        """A progress bar towards a target value (an evolution's time)."""

        def __init__(self, start, stop, total=100, **kwargs):
            kwargs.setdefault("ascii", True)
            super().__init__(total=total, unit="%", **kwargs)
            self.start = start
            self.range = stop - start

        def cupdate(self, x):
            self.update(int(100 * (x - self.start) / self.range) - self.n)

except ImportError:  # pragma: no cover

    class progbar:
        """A stand-in with tqdm's methods, where tqdm is not installed."""

        def __init__(self, it=None, total=None, desc=None, **_):
            self._it = it
            self.total = total
            self.n = 0
            self.desc = desc

        def __iter__(self):
            for x in self._it:
                yield x
                self.n += 1

        def update(self, n=1):
            self.n += n

        def set_description(self, desc, refresh=True):
            self.desc = desc

        def close(self):
            pass

    class continuous_progbar(progbar):
        def __init__(self, start, stop, total=100, **kwargs):
            super().__init__(total=total, **kwargs)

        def cupdate(self, x):
            pass


__all__ = [
    "check_opt", "oset", "LRU", "save_to_disk", "load_from_disk",
    "format_number_with_error", "deprecated", "int2tup", "ensure_dict",
    "pairwise", "unique", "concat", "frequencies", "partition_all",
    "valmap", "tree_map", "tree_apply", "tree_flatten",
    "tree_unflatten", "RollingMeanVar", "Timer",
    "default_to_neutral_style",
]
