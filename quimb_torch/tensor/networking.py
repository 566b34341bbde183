"""Pure-graph algorithms on tensor networks: loops, spanning trees,
paths, patches, centralities, hierarchical grouping.

Re-design of reference ``quimb/tensor/networking.py`` (``gen_loops``
:1106, ``gen_sloops`` :726, ``gen_gloops`` :995, spanning trees :187,
patches :796, hierarchical grouping :1290-1456, centralities :1457).
Host-side, setup-time computations on the tid-graph."""

import collections
import itertools

import numpy as np

from ..utils import oset


def tn_adjacency(tn):
    """tid -> set of neighbouring tids (via shared indices)."""
    adj = {tid: set() for tid in tn.tensor_map}
    for ix, tids in tn.ind_map.items():
        tids = tuple(tids)
        for a, b in itertools.combinations(tids, 2):
            adj[a].add(b)
            adj[b].add(a)
    return adj


def get_tree_span(tn, tids=None, which="any", inwards=True,
                  max_distance=None):
    """A spanning tree of the tid graph as a list of (tid_outer,
    tid_inner, distance) merges, ordered leaves-first (reference
    ``get_tree_span`` networking.py:187) — the order used for
    tree-gauging and cluster contraction."""
    adj = tn_adjacency(tn)
    if tids is None:
        # start from an approximately central tid
        cents = compute_centralities(tn)
        tids = [max(cents, key=cents.get)]
    region = set(tids)
    span = []
    frontier = list(tids)
    dist = {t: 0 for t in tids}
    while True:
        if max_distance is not None and frontier and all(
            dist[t] >= max_distance for t in frontier
        ):
            break
        candidates = []
        for t in frontier:
            for o in adj[t]:
                if o not in region:
                    candidates.append((o, t))
        if not candidates:
            break
        new_frontier = []
        for (o, t) in candidates:
            if o in region:
                continue
            region.add(o)
            dist[o] = dist[t] + 1
            span.append((o, t, dist[o]))
            new_frontier.append(o)
        frontier = new_frontier
    # leaves first = reversed BFS order
    return list(reversed(span))


def gen_all_paths_between_tids(tn, tida, tidb, max_length=None):
    """Yield all simple paths between two tids."""
    adj = tn_adjacency(tn)

    def dfs(path, seen):
        cur = path[-1]
        if cur == tidb:
            yield tuple(path)
            return
        if max_length is not None and len(path) > max_length:
            return
        for o in adj[cur]:
            if o not in seen:
                seen.add(o)
                path.append(o)
                yield from dfs(path, seen)
                path.pop()
                seen.discard(o)

    yield from dfs([tida], {tida})


def gen_loops(tn, max_loop_length=None):
    """Generate simple cycles of tids up to ``max_loop_length``
    (reference ``gen_loops`` networking.py:1106)."""
    adj = tn_adjacency(tn)
    tids = sorted(adj, key=str)
    seen = set()
    if max_loop_length is None:
        max_loop_length = min(len(tids), 8)

    def dfs(start, path):
        cur = path[-1]
        for o in adj[cur]:
            if o == start and len(path) >= 3:
                key = frozenset(path)
                if key not in seen and len(path) <= max_loop_length:
                    seen.add(key)
                    yield tuple(path)
            elif o not in path and len(path) < max_loop_length \
                    and str(o) > str(start):
                path.append(o)
                yield from dfs(start, path)
                path.pop()

    for t in tids:
        yield from dfs(t, [t])


def gen_sloops(tn, max_loop_length=None):
    """Generate 'simple loops': loops with no chords (reference
    ``gen_sloops`` networking.py:726)."""
    adj = tn_adjacency(tn)
    for loop in gen_loops(tn, max_loop_length):
        ok = True
        ls = set(loop)
        for t in loop:
            extra = adj[t] & ls
            # in a chordless cycle every member touches exactly 2
            if len(extra) != 2:
                ok = False
                break
        if ok:
            yield loop


def gen_gloops(tn, max_size=None):
    """Generate 'generalized loops' — connected subgraphs in which
    every tensor has at least two neighbours within the subgraph
    (reference ``gen_gloops`` networking.py:995)."""
    adj = tn_adjacency(tn)
    if max_size is None:
        max_size = min(len(adj), 6)
    seen = set()
    for loop in gen_loops(tn, max_size):
        key = frozenset(loop)
        if key not in seen:
            seen.add(key)
            yield tuple(sorted(loop, key=str))


def gen_patches(tn, max_size=8):
    """Partition tids into connected patches of bounded size
    (reference ``gen_patches`` networking.py:796)."""
    adj = tn_adjacency(tn)
    unassigned = set(adj)
    while unassigned:
        seed = next(iter(unassigned))
        patch = {seed}
        frontier = [seed]
        while frontier and len(patch) < max_size:
            t = frontier.pop(0)
            for o in adj[t]:
                if o in unassigned and o not in patch and \
                        len(patch) < max_size:
                    patch.add(o)
                    frontier.append(o)
        unassigned -= patch
        yield tuple(sorted(patch, key=str))


def compute_centralities(tn, p=0.85, iterations=50):
    """Approximate (eigenvector/pagerank-style) centrality of each tid
    (reference ``compute_centralities`` networking.py:1457)."""
    adj = tn_adjacency(tn)
    tids = list(adj)
    idx = {t: i for i, t in enumerate(tids)}
    n = len(tids)
    if n == 0:
        return {}
    x = np.ones(n) / n
    for _ in range(iterations):
        new = np.full(n, (1 - p) / n)
        for t in tids:
            deg = max(len(adj[t]), 1)
            share = p * x[idx[t]] / deg
            for o in adj[t]:
                new[idx[o]] += share
        x = new / new.sum()
    return {t: float(x[idx[t]]) for t in tids}


def compute_hierarchical_linkage(tn, method="weighted"):
    """Hierarchical clustering linkage of the tid graph by contraction
    affinity (reference networking.py:1290). Returns a scipy linkage
    matrix."""
    import scipy.cluster.hierarchy as sch
    import scipy.spatial.distance as ssd

    tids = list(tn.tensor_map)
    n = len(tids)
    idx = {t: i for i, t in enumerate(tids)}
    # distance = 1 / (1 + log2 shared bond size)
    D = np.full((n, n), 10.0)
    np.fill_diagonal(D, 0.0)
    for ix, holders in tn.ind_map.items():
        holders = tuple(holders)
        d = tn.ind_size(ix)
        for a, b in itertools.combinations(holders, 2):
            w = 1.0 / (1.0 + np.log2(max(d, 2)))
            i, j = idx[a], idx[b]
            D[i, j] = min(D[i, j], w)
            D[j, i] = D[i, j]
    return sch.linkage(ssd.squareform(D, checks=False), method=method)


def compute_hierarchical_ordering(tn, method="weighted"):
    """An ordering of tids from hierarchical clustering (reference
    networking.py:1398)."""
    import scipy.cluster.hierarchy as sch

    tids = list(tn.tensor_map)
    if len(tids) < 3:
        return tuple(tids)
    Z = compute_hierarchical_linkage(tn, method=method)
    order = sch.leaves_list(Z)
    return tuple(tids[i] for i in order)


def istree(tn):
    """Whether the tid graph is a tree (no loops)."""
    adj = tn_adjacency(tn)
    n_edges = sum(len(v) for v in adj.values()) // 2
    # connected components
    seen = set()
    ncomp = 0
    for t in adj:
        if t in seen:
            continue
        ncomp += 1
        stack = [t]
        while stack:
            u = stack.pop()
            if u in seen:
                continue
            seen.add(u)
            stack.extend(adj[u] - seen)
    return n_edges == len(adj) - ncomp


def isconnected(tn):
    adj = tn_adjacency(tn)
    if not adj:
        return True
    seen = set()
    stack = [next(iter(adj))]
    while stack:
        u = stack.pop()
        if u in seen:
            continue
        seen.add(u)
        stack.extend(adj[u] - seen)
    return len(seen) == len(adj)


def subgraphs(tn):
    """Lists of tids of each connected component."""
    adj = tn_adjacency(tn)
    seen = set()
    out = []
    for t in adj:
        if t in seen:
            continue
        comp = set()
        stack = [t]
        while stack:
            u = stack.pop()
            if u in comp:
                continue
            comp.add(u)
            stack.extend(adj[u] - comp)
        seen |= comp
        out.append(sorted(comp, key=str))
    return out


__all__ = [
    "tn_adjacency", "get_tree_span", "gen_all_paths_between_tids",
    "gen_loops", "gen_sloops", "gen_gloops", "gen_patches",
    "compute_centralities", "compute_hierarchical_linkage",
    "compute_hierarchical_ordering", "istree", "isconnected",
    "subgraphs",
]


# ---------------------------------------------------------------------------
# patches/paths containers + queries (reference networking.py:13,72,
# 350,420,875,1131-1482)
# ---------------------------------------------------------------------------

class NetworkPatch:
    """A hashable region of a network: some tensor ids plus some indices
    (fills the role of reference ``NetworkPatch`` networking.py:13).

    Stored as one flat deduplicated element tuple (tids first, then
    inds) with a split point — identity/hashing is by the unordered
    element set, while iteration order stays deterministic (first-seen).
    """

    __slots__ = ("_elems", "_split", "_key")

    def __init__(self, tids, inds):
        utids = tuple(dict.fromkeys(tids))
        self._elems = utids + tuple(dict.fromkeys(inds))
        self._split = len(utids)
        self._key = frozenset(self._elems)

    @classmethod
    def from_sequence(cls, it):
        xs = tuple(it)
        return cls(
            (x for x in xs if isinstance(x, int)),
            (x for x in xs if not isinstance(x, int)),
        )

    @property
    def tids(self):
        return oset(self._elems[:self._split])

    @property
    def inds(self):
        return oset(self._elems[self._split:])

    @property
    def key(self):
        return self._key

    def merge(self, other):
        return NetworkPatch(
            self._elems[:self._split] + other._elems[:other._split],
            self._elems[self._split:] + other._elems[other._split:],
        )

    def __iter__(self):
        return iter(self._elems)

    def __contains__(self, x):
        return x in self._key

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        if isinstance(other, NetworkPatch):
            return self._key == other._key
        return NotImplemented

    def __repr__(self):
        s = self._split
        return (
            f"{type(self).__name__}"
            f"({self._elems[:s]}, {self._elems[s:]})"
        )


class NetworkPath(NetworkPatch):
    """A walk through a TN — n+1 tensor ids joined by n bond indices
    (fills the role of reference ``NetworkPath`` networking.py:72).
    Unlike a patch, order is structural, so tids/inds are plain tuples
    and extension is O(1) amortized.
    """

    __slots__ = ("_t", "_i", "_lazykey")

    def __init__(self, tids, inds=()):
        self._t = tuple(tids)
        self._i = tuple(inds)
        if len(self._t) - len(self._i) != 1:
            raise ValueError("tids should be one longer than inds")
        self._lazykey = None

    @property
    def tids(self):
        return self._t

    @property
    def inds(self):
        return self._i

    @property
    def key(self):
        if self._lazykey is None:
            self._lazykey = frozenset(self._t + self._i)
        return self._lazykey

    def merge(self, other):
        return NetworkPatch(self._t + other.tids,
                            self._i + other.inds)

    def __len__(self):
        return len(self._i)

    def __iter__(self):
        # interleaved: t0, i0, t1, i1, ..., tn
        for pair in zip(self._t, self._i):
            yield from pair
        yield self._t[-1]

    def __contains__(self, x):
        return x in self.key

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        if isinstance(other, NetworkPatch):
            return self.key == other.key
        return NotImplemented

    def extend(self, ind, tid):
        new = NetworkPath.__new__(NetworkPath)
        new._t = self._t + (tid,)
        new._i = self._i + (ind,)
        k = self._lazykey
        new._lazykey = None if k is None else k | {tid, ind}
        return new

    def __repr__(self):
        return f"{type(self).__name__}({self._t}, {self._i})"


def get_path_between_tids(tn, tida, tidb):
    """Shortest :class:`NetworkPath` between two tids via
    bidirectional BFS, ignoring dangling/hyper indices (reference
    ``get_path_between_tids`` networking.py:420)."""
    path_a0 = NetworkPath((tida,))
    path_b0 = NetworkPath((tidb,))
    queue_a = collections.deque((path_a0,))
    queue_b = collections.deque((path_b0,))
    ends_a = {tida: path_a0}
    ends_b = {tidb: path_b0}

    while queue_a or queue_b:
        for queue, ends_this, ends_other, forward in [
            (queue_a, ends_a, ends_b, True),
            (queue_b, ends_b, ends_a, False),
        ]:
            if not queue:
                return None
            path = queue.popleft()
            last_tid = path.tids[-1]
            t = tn.tensor_map[last_tid]
            for next_ind in t.inds:
                if next_ind in path:
                    continue
                tids = tuple(tn.ind_map[next_ind])
                if len(tids) != 2:
                    continue
                next_tid = next(
                    tid for tid in tids if tid != last_tid
                )
                if next_tid in ends_this:
                    continue
                if next_tid in ends_other:
                    other = ends_other[next_tid]
                    if forward:
                        return NetworkPath(
                            path.tids + other.tids[::-1],
                            path.inds + (next_ind,)
                            + other.inds[::-1],
                        )
                    return NetworkPath(
                        other.tids + path.tids[::-1],
                        other.inds + (next_ind,) + path.inds[::-1],
                    )
                next_path = path.extend(next_ind, next_tid)
                ends_this[next_tid] = next_path
                queue.append(next_path)


def tids_are_connected(tn, tids):
    """Whether the given tids form one connected region (reference
    ``tids_are_connected`` networking.py:1204)."""
    tids = list(tids)
    if len(tids) <= 1:
        return True
    adj = tn_adjacency(tn)
    target = set(tids)
    seen = {tids[0]}
    frontier = [tids[0]]
    while frontier:
        t = frontier.pop()
        for o in adj[t]:
            if o in target and o not in seen:
                seen.add(o)
                frontier.append(o)
    return seen == target


def compute_shortest_distances(tn, tids=None, exclude_inds=()):
    """Minimum graph distances between (all or some) pairs of tids
    (reference ``compute_shortest_distances`` networking.py:1233)."""
    if tids is None:
        tids = list(tn.tensor_map)
    else:
        tids = list(tids)
    exclude = set(exclude_inds)
    adj = {tid: set() for tid in tn.tensor_map}
    for ix, ts in tn.ind_map.items():
        if ix in exclude:
            continue
        for a, b in itertools.combinations(tuple(ts), 2):
            adj[a].add(b)
            adj[b].add(a)
    distances = {}
    targets = set(tids)
    for i, start in enumerate(tids):
        # BFS from each target
        dist = {start: 0}
        frontier = collections.deque([start])
        while frontier:
            t = frontier.popleft()
            for o in adj[t]:
                if o not in dist:
                    dist[o] = dist[t] + 1
                    frontier.append(o)
        for other in tids[i + 1:]:
            if other in dist:
                distances[tuple(sorted((start, other)))] = dist[other]
    return distances


def gen_inds_connected(tn, max_length):
    """All connected index patches up to ``max_length`` indices
    (reference ``gen_inds_connected`` networking.py:1171)."""
    # index adjacency: two inds are neighbours if they share a tensor
    ind_adj = collections.defaultdict(set)
    for tid, t in tn.tensor_map.items():
        for a, b in itertools.combinations(t.inds, 2):
            ind_adj[a].add(b)
            ind_adj[b].add(a)
    queue = [(ix,) for ix in tn.ind_map]
    seen = {frozenset(s) for s in queue}
    while queue:
        s = queue.pop()
        if len(s) == max_length:
            continue
        for last in s:
            for ix in ind_adj[last]:
                next_s = s + (ix,)
                key = frozenset(next_s)
                if ix not in s and key not in seen:
                    yield next_s
                    seen.add(key)
                    queue.append(next_s)


def gen_paths_loops(tn, max_loop_length=None, intersect=False,
                    tids=None, inds=None):
    """Generate both open paths and closed loops up to a maximum
    length (reference ``gen_paths_loops`` networking.py:576). Paths
    are tuples of tids; loops are closed tuples from
    :func:`gen_loops`."""
    adj = tn_adjacency(tn)
    if max_loop_length is None:
        max_loop_length = min(len(adj), 6)
    seen = set()
    # open paths by DFS
    for start in sorted(adj, key=str):
        stack = [(start,)]
        while stack:
            path = stack.pop()
            if len(path) > 1:
                key = frozenset(path)
                if key not in seen:
                    seen.add(key)
                    yield tuple(path)
            if len(path) < max_loop_length:
                for o in adj[path[-1]]:
                    if o not in path and str(o) > str(start):
                        stack.append(path + (o,))
    yield from gen_loops(tn, max_loop_length)


def get_local_patch(tn, tids, max_distance=1):
    """All tids within graph distance ``max_distance`` of the given
    region (reference ``get_local_patch`` networking.py:350)."""
    adj = tn_adjacency(tn)
    region = set(tids)
    frontier = set(tids)
    for _ in range(max_distance):
        new = set()
        for t in frontier:
            new.update(adj[t])
        new -= region
        region |= new
        frontier = new
    return tuple(sorted(region, key=str))


def get_loop_union(tn, tids, max_size=None, grow_from="all"):
    """Union of all generalized loops through the given tids
    (reference ``get_loop_union`` networking.py:1131)."""
    tids = set(tids)
    out = set()
    for loop in gen_gloops(tn, max_size=max_size):
        ls = set(loop)
        if grow_from == "all":
            if tids <= ls:
                out |= ls
        elif tids & ls:
            out |= ls
    return tuple(sorted(out, key=str))


def connected_bipartitions(tn):
    """Yield all bipartitions of the tids into two connected halves
    (reference ``connected_bipartitions`` networking.py:875)."""
    tids = sorted(tn.tensor_map, key=str)
    n = len(tids)
    seen = set()
    for r in range(1, n // 2 + 1):
        for combo in itertools.combinations(tids, r):
            rest = tuple(t for t in tids if t not in combo)
            key = frozenset((frozenset(combo), frozenset(rest)))
            if key in seen:
                continue
            seen.add(key)
            if tids_are_connected(tn, combo) and \
                    tids_are_connected(tn, rest):
                yield (tuple(combo), rest)


def most_central_tid(tn):
    """The tid with the highest centrality (reference
    ``most_central_tid`` networking.py:1476)."""
    c = compute_centralities(tn)
    return max(c, key=c.get)


def least_central_tid(tn):
    """The tid with the lowest centrality (reference
    ``least_central_tid`` networking.py:1482)."""
    c = compute_centralities(tn)
    return min(c, key=c.get)


def compute_hierarchical_grouping(tn, max_group_size=8,
                                  method="weighted"):
    """Group tids hierarchically into clusters of bounded size, in
    linkage order (reference ``compute_hierarchical_grouping``
    networking.py:1391)."""
    order = compute_hierarchical_ordering(tn, method=method)
    groups = []
    cur = []
    for tid in order:
        cur.append(tid)
        if len(cur) == max_group_size:
            groups.append(tuple(cur))
            cur = []
    if cur:
        groups.append(tuple(cur))
    return groups


def compute_hierarchical_ssa_path(tn, method="weighted"):
    """The hierarchical linkage as an ssa (single static assignment)
    contraction path (reference ``compute_hierarchical_ssa_path``
    networking.py:1331): scipy linkage rows are already ssa merges."""
    Z = compute_hierarchical_linkage(tn, method=method)
    return tuple((int(row[0]), int(row[1])) for row in Z)
