"""Small utilities of the tensor-network layer: option checks, the
insertion-ordered set that holds indices and tags, an LRU cache dict, and
a few iteration helpers. A copy of the parts of quimb_tpu's ``utils`` that
the layer uses; plain Python, nothing of torch."""

import collections
import collections.abc
import itertools

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
